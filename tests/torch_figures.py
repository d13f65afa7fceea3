"""Figure comparison for the port's plot tests: what a matplotlib figure
draws, as plain data, so that a JAX-package figure and the port's can be
held equal."""

import numpy as np


def figure_lines(fig_or_ax):
    """Per axes of the figure (or of the axes' figure): the number of
    artists (lines, patches, texts, collections), the title, and each
    line's x and y data as float64 arrays."""
    fig = getattr(fig_or_ax, "figure", None) or fig_or_ax
    out = []
    for ax in fig.axes:
        lines = [(np.asarray(ln.get_xdata(), dtype=np.float64),
                  np.asarray(ln.get_ydata(), dtype=np.float64)) for ln in ax.lines]
        n_artists = len(ax.lines) + len(ax.patches) + len(ax.texts) + len(ax.collections)
        out.append((n_artists, ax.get_title(), lines))
    return out


def assert_same_figure(ref, got, tag=""):
    """The same artists and titles per axes, and every line's data equal
    exactly (NaN where NaN)."""
    a, b = figure_lines(ref), figure_lines(got)
    assert len(a) == len(b), (tag, len(a), len(b))
    for i, ((na, ta, la), (nb, tb, lb)) in enumerate(zip(a, b)):
        assert (na, ta, len(la)) == (nb, tb, len(lb)), (tag, i, (na, ta, len(la)), (nb, tb, len(lb)))
        for j, ((xa, ya), (xb, yb)) in enumerate(zip(la, lb)):
            np.testing.assert_array_equal(xb, xa, err_msg=f"{tag} axes {i} line {j} x")
            np.testing.assert_array_equal(yb, ya, err_msg=f"{tag} axes {i} line {j} y")
