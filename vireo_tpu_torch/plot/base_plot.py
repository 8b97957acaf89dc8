"""Host-side plotting (counterpart of vireo_tpu/plot/base_plot.py).

The reference's plotting surface (vireoSNP/plot/base_plot.py):
annotated heatmaps, the genotype-distance figures the `vireo` CLI
writes, GTbarcode's mini-code plot and the annotation-grouped
clustermap. matplotlib (and seaborn, for `anno_heat`) are imported
inside the functions, so importing this module, or running the model,
needs neither.
"""

import numpy as np

vireo_colors = np.array(['#4796d7', '#f79e54', '#79a702', '#df5858',
                         '#556cab', '#de7a1f', '#ffda5c', '#4b595c',
                         '#6ab186', '#bddbcf', '#daad58', '#488a99',
                         '#f79b78', '#ffba00'])


# ---------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------

def _label_axis(ax, which, labels, rotation=0):
    """Put categorical tick labels on one axis and clamp its limits to
    the matrix extent."""
    if labels is None:
        return
    ticks = np.arange(len(labels))
    lim = (-0.5, len(labels) - 0.5)
    if which == "x":
        ax.set_xticks(ticks, labels=list(labels), rotation=rotation)
        ax.set_xlim(*lim)
    else:
        ax.set_yticks(ticks, labels=list(labels))
        ax.set_ylim(*lim)


def _annotate_cells(ax, M, fmt):
    """Write fmt(value) centered in every cell of an imshow'd matrix."""
    for (i, j), v in np.ndenumerate(M):
        ax.text(j, i, fmt(v), ha="center", va="center", color="k")


def _binary_row_order(X):
    """Row order by the binary code of each row (reference's row_sort
    trick, base_plot.py:60-61): row value = X @ (1, 2, 4, ...)."""
    return np.argsort(X @ (2 ** np.arange(X.shape[1])))


# ---------------------------------------------------------------------
# public surface
# ---------------------------------------------------------------------

def heat_matrix(X, yticks=None, xticks=None, rotation=45, cmap='BuGn',
                alpha=0.6, display_value=True, row_sort=False,
                aspect='auto', interpolation='none', **kwargs):
    """Annotated heatmap on the current axes; returns the image handle
    (same call surface as base_plot.py:9-79)."""
    import matplotlib.pyplot as plt

    X = np.asarray(X)
    if row_sort:
        X = X[_binary_row_order(X)]

    ax = plt.gca()
    im = ax.imshow(X, cmap=cmap, alpha=alpha, aspect=aspect,
                   interpolation=interpolation, **kwargs)
    _label_axis(ax, "x", xticks, rotation=rotation)
    _label_axis(ax, "y", yticks)
    if display_value:
        _annotate_cells(ax, X, lambda v: "%.2f" % v)
    return im


def _gt_distance(A, B):
    """Mean absolute genotype-probability distance between donor slices."""
    Af = np.swapaxes(np.asarray(A), 0, 1).reshape(A.shape[1], -1)
    Bf = np.swapaxes(np.asarray(B), 0, 1).reshape(B.shape[1], -1)
    return np.abs(Af[:, None, :] - Bf[None, :, :]).mean(axis=2)


def plot_GT(out_dir, cell_GPb, donor_names, donor_GPb=None,
            donor_names_in=None):
    """Write fig_GT_distance_estimated.pdf (and _input.pdf when donor
    genotypes were provided), as the CLI does (base_plot.py:82-114)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def save(dist, cols, fname):
        fig = plt.figure()
        heat_matrix(dist, donor_names, cols)
        plt.title("Geno Prob Delta: %d SNPs" % (cell_GPb.shape[0]))
        plt.tight_layout()
        fig.savefig(out_dir + "/" + fname, dpi=300)
        plt.close(fig)

    save(_gt_distance(cell_GPb, cell_GPb), donor_names,
         "fig_GT_distance_estimated.pdf")
    if donor_GPb is not None:
        save(_gt_distance(cell_GPb, donor_GPb), donor_names_in,
             "fig_GT_distance_input.pdf")


def minicode_plot(barcode_set, var_ids=None, sample_ids=None,
                  cmap="Set3", interpolation='none', **kwargs):
    """Genotype-barcode matrix plot for GTbarcode: variants x donors,
    one colored integer per genotype (base_plot.py:117-146). Barcode
    strings carry a leading '#'."""
    import matplotlib.pyplot as plt

    M = np.array([[float(c) for c in bc[1:]] for bc in barcode_set]).T

    ax = plt.gca()
    im = ax.imshow(M, cmap=cmap, interpolation=interpolation, **kwargs)
    _annotate_cells(ax, M, lambda v: int(v))

    _label_axis(ax, "y", var_ids if var_ids is not None
                else range(M.shape[0]))
    tags = sample_ids if sample_ids is not None \
        else ["S%d" % x for x in range(M.shape[1])]
    _label_axis(ax, "x", ["%s\n%s" % (bc, tag)
                          for bc, tag in zip(barcode_set, tags)])
    return im


def _group_layout(anno, order_ids, n_other):
    """Ordering and swatch colors for one annotated axis of anno_heat.

    Returns (permutation grouping equal annotations together, one color
    per element, the group label list). `n_other` is the length of the
    opposite axis (kept for parity with the reference's argsort weight,
    which does not change the order)."""
    ids = list(np.unique(anno)) if order_ids is None else list(order_ids)
    group_of = np.array([ids.index(a) for a in anno])
    perm = np.argsort(group_of, kind="stable")
    return perm, vireo_colors[group_of[perm]], ids


def _add_swatch_legend(ax, labels, ncol):
    """Zero-size bars on a dendrogram axis double as legend swatches."""
    for i, lab in enumerate(labels):
        ax.bar(0, 0, color=vireo_colors[i], label=lab, linewidth=0)
    ax.legend(loc="center", ncol=ncol, title="")


def anno_heat(X, row_anno=None, col_anno=None, row_order_ids=None,
              col_order_ids=None, xticklabels=False, yticklabels=False,
              row_cluster=False, col_cluster=False, **kwargs):
    """Clustermap with rows/columns grouped by categorical annotations
    and per-group color strips + legends (base_plot.py:149-218)."""
    import seaborn as sns

    X = np.asarray(X)
    idx_row, row_colors, row_ids = (
        _group_layout(row_anno, row_order_ids, X.shape[1])
        if row_anno is not None
        else (np.arange(X.shape[0]), None, []))
    idx_col, col_colors, col_ids = (
        _group_layout(col_anno, col_order_ids, X.shape[0])
        if col_anno is not None
        else (np.arange(X.shape[1]), None, []))

    g = sns.clustermap(X[np.ix_(idx_row, idx_col)],
                       row_colors=row_colors, col_colors=col_colors,
                       col_cluster=col_cluster, row_cluster=row_cluster,
                       xticklabels=xticklabels, yticklabels=yticklabels,
                       **kwargs)
    if row_anno is not None:
        _add_swatch_legend(g.ax_row_dendrogram, row_ids, ncol=1)
    if col_anno is not None:
        _add_swatch_legend(g.ax_col_dendrogram, col_ids, ncol=6)
    g.cax.set_position([1.01, .2, .03, .45])
    return g
