"""Plots of the port (counterpart of vireo_tpu/plot); matplotlib is
imported only when a function is called."""

from .base_plot import heat_matrix, plot_GT, minicode_plot, anno_heat
from .base_plot import vireo_colors

__all__ = ["heat_matrix", "plot_GT", "minicode_plot", "anno_heat",
           "vireo_colors"]
