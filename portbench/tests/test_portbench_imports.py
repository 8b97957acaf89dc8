"""What a run loads and reads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `vireo_tpu` (whole names: `vireo_tpu_torch` is the
program), nothing read under `benchmarks/`, and a reference that
imports nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from helpers import BENCH, ROOT

RUN_A_CELL = r'''
import json, os, sys, tempfile, time
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and args and isinstance(args[0], str) else None)
sys.path[:0] = [%(root)r, %(tests)r]
os.environ["VIREO_PLATFORM"] = "cpu"
import torch
from helpers import tiny_checkout
from portbench.harness.run_cell import run_cell, forbidden_modules
root = tiny_checkout(tempfile.mkdtemp(), entry=%(entry)r, traffic="from_host")
out, _ = run_cell("tiny.cell", 5, 0.2, %(trace)s, torch.device("cpu"),
                  time.perf_counter(), root=root, log=lambda m: None)
print(json.dumps({"correct": out["correct"], "forbidden": forbidden_modules(),
                  "opened": opened}))
'''


def _run(entry, trace):
    code = RUN_A_CELL % dict(root=str(ROOT), tests=str(BENCH / "tests"),
                             entry=entry, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks():
    for entry, trace in (("vireo_wrap", True), ("sweep_n_donor", False)):
        res = _run(entry, trace)
        assert res["correct"]
        assert res["forbidden"] == []
        bench = str(ROOT / "benchmarks")
        assert not [p for p in res["opened"] if p.startswith(bench)]


def test_forbidden_names_are_whole_top_level_names():
    from portbench.harness import run_cell
    saved = dict(sys.modules)
    try:
        sys.modules["vireo_tpu_torch_fake"] = sys
        sys.modules["jaxtyping_fake.sub"] = sys
        assert run_cell.forbidden_modules() == []
        sys.modules["vireo_tpu.ops"] = sys
        sys.modules["jax"] = sys
        assert run_cell.forbidden_modules() == ["jax", "vireo_tpu.ops"]
    finally:
        for k in set(sys.modules) - set(saved):
            del sys.modules[k]


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


FORBIDDEN = {"vireo_tpu_torch", "vireo_tpu", "jax", "jaxlib", "flax"}

RUN_THE_REFERENCE = r'''
import sys
sys.path.insert(0, %(root)r)
import torch
from portbench.harness.manifest import Manifest
from portbench.harness.pool import make_pool, to_host
from portbench.reference import vireo as ref
from portbench.reference.counts import Arith, RefCounts
AD, DP = to_host(make_pool(seed=2**31 + 7, device=torch.device("cpu"),
                           n_var=60, n_cell=200, n_donor=3,
                           doublet_rate=0.08, density=0.3,
                           mean_extra_depth=0.6))
counts = RefCounts(AD, DP, "cpu")
m = Manifest()
for arith in ("float64", "tf32"):
    one = ref.vireo_wrap(counts, 3, 2, 5, Arith(arith))
    m.entry("vireo_wrap").compare(one, one)
    sweep = ref.sweep_n_donor(counts, (2, 3), 2, 5, Arith(arith))
    m.entry("sweep_n_donor").compare(sweep, sweep)
print(sorted({m.split(".")[0] for m in sys.modules}))
'''


def test_the_reference_imports_nothing_of_the_program():
    """Neither the reference's sources nor a run of it, with the entries'
    comparisons, load the program, JAX or the JAX package."""
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
    proc = subprocess.run(
        [sys.executable, "-c", RUN_THE_REFERENCE % dict(root=str(ROOT))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1]
                        .replace("'", '"'))
    assert "torch" in loaded
    assert not set(loaded) & FORBIDDEN


REFUSE_AFTER_THE_CHECK = r'''
import importlib.util, os, sys, types
sys.path.insert(0, %(root)r)
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from portbench.harness import run_cell


def late_jax(*args, **kwargs):
    # the comparison after the window loads JAX
    sys.modules["jaxlib"] = types.ModuleType("jaxlib")
    return {"correct": True}, []


run_cell.run_cell = late_jax
spec = importlib.util.spec_from_file_location("run", %(run)r)
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
os._exit(run.main(["--workload", "pool16.placed", "--seed", "1",
                   "--seconds", "1", "--trace", "0"]))
'''


def test_run_gives_no_result_once_jax_is_loaded():
    """run.py looks again just before it writes the result: a module of
    JAX loaded after the window, by the comparison, stops the result."""
    code = REFUSE_AFTER_THE_CHECK % dict(root=str(ROOT),
                                         run=str(BENCH / "run.py"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode not in (0, None)
    assert proc.stdout.strip() == ""
    assert "jaxlib" in proc.stderr


def test_no_source_names_the_jax_package_or_benchmarks():
    for path in sorted(BENCH.rglob("*.py")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN - {"vireo_tpu_torch"}, path


def test_run_exits_nonzero_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "pool16.placed",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
