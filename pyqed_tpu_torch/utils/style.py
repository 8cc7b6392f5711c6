"""Publication-style matplotlib wrappers and data export.

PyTorch counterpart of ``pyqed_tpu/utils/style.py``: thin, headless-safe
(Agg) wrappers; every function accepts NumPy arrays or tensors (on any
device; they are copied to the host) and returns (fig, ax) so scripts can
post-edit. matplotlib is imported only inside the functions that draw, so
``import pyqed_tpu_torch`` runs without it.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """``a`` as a NumPy array (a tensor is copied to the host)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().resolve_conj().numpy()
    return np.asarray(a)


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def set_style(fontsize=12):
    """Publication rc defaults, without a LaTeX dependency (keeps
    headless images reproducible)."""
    import matplotlib
    matplotlib.rcParams.update({
        "font.size": fontsize,
        "axes.labelsize": fontsize,
        "axes.linewidth": 1.0,
        "xtick.direction": "in",
        "ytick.direction": "in",
        "xtick.top": True,
        "ytick.right": True,
        "lines.linewidth": 1.5,
        "savefig.dpi": 160,
        "savefig.bbox": "tight",
    })


def subplots(nrows=1, ncols=1, figsize=(4, 3), sharex=True, sharey=False,
             **kwargs):
    plt = _mpl()
    set_style()
    return plt.subplots(nrows, ncols, figsize=figsize, sharex=sharex,
                        sharey=sharey, **kwargs)


def curve(x, y, xlabel=None, ylabel=None, output=None, ax=None, **kwargs):
    plt = _mpl()
    x = _host(x)
    y = _host(y)
    if ax is None:
        fig, ax = subplots()
    else:
        fig = ax.figure
    if y.ndim == 1:
        ax.plot(x, y, **kwargs)
    else:
        for col in y.T:
            ax.plot(x, col, **kwargs)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if output:
        fig.savefig(output)
        plt.close(fig)
    return fig, ax


def matplot(x, y, f, vmin=None, vmax=None, output=None, xlabel="X",
            ylabel="Y", cmap="viridis", contour=False, diverge=False):
    """2D map of f(x, y). f is indexed (len(x), len(y))."""
    plt = _mpl()
    x, y, f = _host(x), _host(y), np.real(_host(f))
    if diverge:
        m = np.max(np.abs(f))
        vmin = -m if vmin is None else vmin
        vmax = m if vmax is None else vmax
        cmap = "RdBu_r"
    fig, ax = subplots()
    im = ax.pcolormesh(x, y, f.T, vmin=vmin, vmax=vmax, cmap=cmap,
                       shading="auto")
    if contour:
        ax.contour(x, y, f.T, colors="k", linewidths=0.4)
    fig.colorbar(im, ax=ax)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if output:
        fig.savefig(output)
        plt.close(fig)
    return fig, ax


def imshow(x, y, f, **kwargs):
    """The same surface as :func:`matplot`."""
    return matplot(x, y, f, **kwargs)


def level_scheme(E, ylim=None, fname=None, width=0.6):
    """Horizontal energy-level diagram."""
    plt = _mpl()
    E = np.sort(np.real(_host(E)).ravel())
    fig, ax = subplots(figsize=(2.4, 4), sharex=False)
    for e in E:
        ax.hlines(e, -width / 2, width / 2, colors="C0")
    ax.set_xlim(-1, 1)
    ax.set_xticks([])
    ax.set_ylabel("Energy")
    if ylim:
        ax.set_ylim(*ylim)
    if fname:
        fig.savefig(fname)
        plt.close(fig)
    return fig, ax


def two_scales(x, yl, yr, xlabel=None, ylabels=(None, None), output=None):
    """Left/right twin-axis plot."""
    plt = _mpl()
    fig, ax = subplots()
    ax.plot(_host(x), _host(yl), "C0-")
    ax2 = ax.twinx()
    ax2.plot(_host(x), _host(yr), "C1--")
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabels[0]:
        ax.set_ylabel(ylabels[0], color="C0")
    if ylabels[1]:
        ax2.set_ylabel(ylabels[1], color="C1")
    if output:
        fig.savefig(output)
        plt.close(fig)
    return fig, (ax, ax2)


def surf(x, y, f, fname=None, xlabel="X", ylabel="Y", zlabel=None,
         cmap="viridis"):
    """3D surface plot."""
    plt = _mpl()
    set_style()
    X, Y = np.meshgrid(_host(x), _host(y), indexing="ij")
    fig = plt.figure(figsize=(5, 4))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(X, Y, np.real(_host(f)), cmap=cmap,
                    linewidth=0, antialiased=True)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if zlabel:
        ax.set_zlabel(zlabel)
    if fname:
        fig.savefig(fname)
        plt.close(fig)
    return fig, ax


def plot_surface(x, y, surface, **kwargs):
    """The same surface as :func:`surf`."""
    return surf(x, y, surface, **kwargs)


def plot_surfaces(x, y, surfaces, fname=None, **kwargs):
    """Several stacked surfaces — e.g. coupled APES sheets."""
    plt = _mpl()
    set_style()
    X, Y = np.meshgrid(_host(x), _host(y), indexing="ij")
    fig = plt.figure(figsize=(5, 4))
    ax = fig.add_subplot(projection="3d")
    for k, s in enumerate(surfaces):
        ax.plot_surface(X, Y, np.real(_host(s)), alpha=0.8,
                        linewidth=0)
    if fname:
        fig.savefig(fname)
        plt.close(fig)
    return fig, ax


def export(x, y, z=None, fname="output.dat", fmt="gnuplot"):
    """Write xy(z) data as text (gnuplot block format with a blank line
    between x-slices)."""
    x = _host(x)
    y = _host(y)
    with open(fname, "w") as f:
        if z is None:
            for xi, yi in zip(x, np.atleast_2d(y.T).T):
                f.write(f"{xi} " + " ".join(str(v)
                                            for v in np.atleast_1d(yi))
                        + "\n")
        else:
            z = _host(z)
            for i, xi in enumerate(x):
                for j, yj in enumerate(y):
                    f.write(f"{xi} {yj} {z[i, j]}\n")
                if fmt == "gnuplot":
                    f.write("\n")
    return fname


def read_result(fname):
    """Load a Result NPZ dump (``core.result.load_result``; tensors on
    the CPU)."""
    from ..core.result import load_result
    return load_result(fname)
