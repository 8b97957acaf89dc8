"""The machine code (SASS) of the port's built kernel libraries, read with
`cuobjdump` from the CUDA toolkit, and a comparison of two checkouts'.

    python -m vireo_tpu_torch.ops.sass OTHER_CHECKOUT [NAME ...]

builds each kernel library NAME (by default every `csrc/*.cu` that both
checkouts have) from this checkout's `csrc/` and from OTHER_CHECKOUT's
with the same nvcc and flags, into a temporary directory, and prints for
each kernel function its registers and instruction count in both and
whether its instructions are the same. A function is matched by its
name, else by its instructions (a template that gained a parameter with
a default keeps its code under a longer name). Names leave out the hash
that nvcc gives an anonymous namespace, which differs between two
copies of one file. It exits with 1 when a function differs or is in
one library only. It needs nvcc and cuobjdump, not a card.
"""

import argparse
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from . import _build

__all__ = ["cuobjdump", "plain_names", "functions", "registers",
           "opcode_counts", "dump",
           "build", "compare", "main"]

_FUNCTION = re.compile(r"\bFunction\s*:?\s*([^\s:]+)")
_INSTRUCTION = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_REG = re.compile(r"\bREG:(\d+)")
_ANON = re.compile(r"(\d+)_GLOBAL__N__")


def plain_names(text):
    """text with every mangled anonymous namespace (`49_GLOBAL__N__<hash>
    _16_packed_counts_cu_<hash>`) written as `11_GLOBAL__N_`."""
    while True:
        m = _ANON.search(text)
        if not m:
            return text
        text = (text[:m.start()] + "11_GLOBAL__N_"
                + text[m.end(1) + int(m.group(1)):])


def cuobjdump():
    """cuobjdump beside nvcc."""
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        raise RuntimeError("cuobjdump not found beside nvcc (%s)" % tool)
    return str(tool)


def _run(args):
    return subprocess.run(args, capture_output=True, text=True,
                          check=True).stdout


def functions(text):
    """{mangled name: [instruction, ...]} from `cuobjdump -sass` output;
    an instruction is its text without its address and encoding (names
    as `plain_names` writes them)."""
    out, fn = {}, None
    for line in plain_names(text).splitlines():
        m = _FUNCTION.search(line)
        if m:
            fn = m.group(1)
            out[fn] = []
            continue
        m = _INSTRUCTION.match(line)
        if fn is not None and m:
            out[fn].append(m.group(1))
    return out


def registers(text):
    """{mangled name: registers a thread} from `cuobjdump -res-usage`
    (names as `plain_names` writes them)."""
    out, fn = {}, None
    for line in plain_names(text).splitlines():
        m = _FUNCTION.search(line)
        if m:
            fn = m.group(1)
            line = line[m.end():]
        m = _REG.search(line)
        if fn is not None and m:
            out[fn] = int(m.group(1))
            fn = None
    return out


def opcode_counts(instructions):
    """{opcode: count} of a function's instructions, the opcode without
    its predicate and modifiers (`@!P0 IADD3.X R1, ...` is IADD3)."""
    counts = {}
    for ins in instructions:
        words = ins.split()
        if words and words[0].startswith("@"):
            words = words[1:]
        if words:
            op = words[0].split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return counts


def dump(lib):
    """(functions, registers) of the built library `lib`."""
    tool = cuobjdump()
    return (functions(_run([tool, "-sass", str(lib)])),
            registers(_run([tool, "-res-usage", str(lib)])))


def build(src, out):
    """nvcc src -> out with the port's flags; raises on a failed build."""
    cmd = _build.nvcc_command(src, out, nvcc=_build.find_nvcc())
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("building %s failed:\n%s%s"
                           % (src, proc.stdout, proc.stderr))
    return out


def compare(mine, theirs):
    """Lines comparing two libraries' (functions, registers), and the
    number of functions that differ or are in one of them only. A
    function of `mine` is matched with the one of that name in `theirs`,
    else with one that has its instructions and no match of its own."""
    (fa, ra), (fb, rb) = mine, theirs
    by_code = {}
    for fn in sorted(set(fb) - set(fa)):
        by_code.setdefault(tuple(fb[fn]), []).append(fn)
    lines, bad, matched = [], 0, set()
    for fn in sorted(fa):
        twin = fn if fn in fb else next(iter(by_code.get(tuple(fa[fn]), [])),
                                        None)
        if twin is None:
            bad += 1
            lines.append("only in this checkout: %s" % fn)
            continue
        if twin != fn:
            by_code[tuple(fa[fn])].remove(twin)
        matched.add(twin)
        same = fa[fn] == fb[twin]
        bad += not same
        lines.append("%s  %5d / %5d instructions  %3s / %3s registers  %s%s"
                     % ("same   " if same else "DIFFERS", len(fa[fn]),
                        len(fb[twin]), ra.get(fn, "?"), rb.get(twin, "?"),
                        fn, "" if twin == fn else " (there %s)" % twin))
    for fn in sorted(set(fb) - matched):
        bad += 1
        lines.append("only in the other: %s" % fn)
    return lines, bad


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m vireo_tpu_torch.ops.sass",
        description="Compare the SASS of this checkout's kernel libraries "
                    "with another checkout's.")
    ap.add_argument("other", type=Path, help="the other checkout's root")
    ap.add_argument("names", nargs="*",
                    help="kernel libraries (csrc/<name>.cu); default all "
                         "that both checkouts have")
    args = ap.parse_args(argv)
    other_csrc = args.other / "vireo_tpu_torch" / "csrc"
    names = args.names or sorted(
        p.stem for p in _build.CSRC_DIR.glob("*.cu")
        if (other_csrc / p.name).is_file())
    bad = 0
    with tempfile.TemporaryDirectory() as work, \
            ThreadPoolExecutor(2 * len(names)) as pool:
        # every nvcc at once
        libs = {(name, i): pool.submit(build, src, Path(work) / (
                    "%s_%d.so" % (name, i)))
                for name in names
                for i, src in enumerate((_build.source_path(name),
                                         other_csrc / (name + ".cu")))}
        for name in names:
            lines, n_bad = compare(dump(libs[name, 0].result()),
                                   dump(libs[name, 1].result()))
            bad += n_bad
            print("%s.cu: %d functions, %d differ (this checkout / %s)"
                  % (name, len(lines), n_bad, args.other), flush=True)
            for line in lines:
                print("  " + line, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
