"""Beam presentation layer: unified draw dispatch, video export and
volume slicing.

PyTorch counterpart of ``pyqed_tpu/beam/drawing.py``. The per-type
``draw`` methods live on the field classes (``beam._add_draw_methods``);
this module adds:

* :func:`prepare_drawing` / :func:`normalize_draw` — the array
  transforms, standalone, for scripts that post-process field data;
* :func:`field_view` — the one view transform every drawing path shares;
* :func:`draw` — one entry point that dispatches any field object
  (X/XY/XZ/XYZ/vector) to its drawing, an XYZ volume to :func:`slices`;
* :func:`video` — Agg-safe z-scan animation export: ffmpeg when
  available, else an animated GIF;
* :func:`slices` — a static orthogonal-slice figure through any point of
  an (x, y, z) volume.

Tensors (on any device) are copied to the host before drawing. matplotlib
is imported only inside the functions that draw, so importing this module
and every non-drawing path run without it.
"""
from __future__ import annotations

import numpy as np

from ..utils.style import _mpl, set_style
from .beam import draw_several_fields  # noqa: F401
from .fieldutils import _host

__all__ = ["prepare_drawing", "normalize_draw", "field_view", "draw",
           "draw_several_fields", "video", "slices"]


# ------------------------------------------------------------ transforms
def prepare_drawing(u, kind="intensity"):
    """Field array or tensor -> drawable real NumPy array.

    kind: 'intensity' |u|^2, 'amplitude' |u|, 'phase' arg(u) (radians),
    'real', 'imag', 'field' (the real part).
    """
    u = _host(u)
    if kind == "intensity":
        return np.abs(u) ** 2
    if kind == "amplitude":
        return np.abs(u)
    if kind == "phase":
        return np.angle(u)
    if kind in ("real", "field"):
        return np.real(u)
    if kind == "imag":
        return np.imag(u)
    raise ValueError(f"kind {kind!r}: use intensity/amplitude/phase/"
                     f"real/imag/field")


def normalize_draw(img, logarithm=False, normalize=False, cut_value=None):
    """Post-transform scaling: optional log1p compression, peak
    normalization, and upper clip.

    NOTE: drawing entry points do NOT apply this to kind='phase'
    (phase renders in raw radians, the per-class draw convention) —
    use :func:`field_view` to get the convention-correct transform."""
    img = np.asarray(_host(img), float)
    if logarithm:
        img = np.log1p(np.abs(img)) * np.sign(img)
    if normalize:
        m = np.max(np.abs(img))
        if m > 0:
            img = img / m
    if cut_value is not None:
        img = np.clip(img, None, cut_value)
    return img


def field_view(u, kind="intensity", logarithm=False, normalize=False,
               cut_value=None):
    """The ONE view transform every drawing path shares:
    prepare_drawing, then normalize_draw — except phase, which always
    renders raw in radians (normalizing an angle would relabel the
    colorbar to ~[-1, 1])."""
    img = prepare_drawing(u, kind)
    if kind == "phase":
        return img
    return normalize_draw(img, logarithm=logarithm, normalize=normalize,
                          cut_value=cut_value)


# ----------------------------------------------------------- dispatching
def draw(field, kind="intensity", logarithm=False, normalize=False,
         cut_value=None, filename="", **kwargs):
    """Draw ANY beam field through one entry point.

    X/XY/XZ/vector fields dispatch to their class ``draw`` methods;
    a :class:`ScalarFieldXYZ` volume routes to :func:`slices`.
    Returns (fig, ax/axes)."""
    from .beam import ScalarFieldXYZ
    if isinstance(field, ScalarFieldXYZ):
        return slices(field, kind=kind, logarithm=logarithm,
                      normalize=normalize, cut_value=cut_value,
                      output=filename or None, **kwargs)
    if not hasattr(field, "draw"):
        raise TypeError(f"cannot draw {type(field).__name__}")
    return field.draw(kind=kind, logarithm=logarithm, normalize=normalize,
                      cut_value=cut_value, filename=filename, **kwargs)


# ----------------------------------------------------------------- video
def video(field, filename, kind="intensity", logarithm=False,
          normalize=True, fps=15, cmap="inferno", dpi=100):
    """Export a z-scan animation of an XZ/XYZ field (or a raw
    (nframes, nx[, ny]) array stack) — Agg-safe, no display needed.
    Writes mp4 via ffmpeg when available,
    otherwise an animated GIF via Pillow.  Returns the filename
    actually written."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib import animation
    set_style()

    from .beam import ScalarFieldXZ, ScalarFieldXYZ
    if isinstance(field, ScalarFieldXZ):
        frames, xaxis, yaxis = _host(field.u), field.x, None
    elif isinstance(field, ScalarFieldXYZ):
        frames, xaxis, yaxis = _host(field.u), field.x, field.y
    else:
        frames = _host(field)
        xaxis = np.arange(frames.shape[1])
        yaxis = np.arange(frames.shape[2]) if frames.ndim == 3 else None

    imgs = field_view(frames, kind, logarithm, normalize)
    # color limits from the DATA (kind='real'/'imag' can be all-negative)
    vmin = float(np.min(imgs))
    vmax = float(np.max(imgs))
    if vmax <= vmin:
        vmax = vmin + 1.0
    fig, ax = plt.subplots(figsize=(4, 3))
    if imgs.ndim == 3:                       # (nz, nx, ny) planes
        art = ax.pcolormesh(np.asarray(xaxis), np.asarray(yaxis),
                            imgs[0].T, vmin=vmin,
                            vmax=vmax, cmap=cmap, shading="auto")

        def update(i):
            art.set_array(imgs[i].T.ravel())
            return (art,)
    else:                                    # (nz, nx) profiles
        (line,) = ax.plot(xaxis, imgs[0])
        pad = 0.05 * (vmax - vmin)
        ax.set_ylim(vmin - pad, vmax + pad)

        def update(i):
            line.set_ydata(imgs[i])
            return (line,)

    anim = animation.FuncAnimation(fig, update, frames=len(imgs),
                                   blit=True)
    # probe writer availability UP FRONT: a mid-encode failure must
    # propagate (a bare fallback would mask real rendering errors and
    # leave a truncated .mp4 next to the .gif)
    if (filename.endswith(".gif")
            or not animation.writers.is_available("ffmpeg")):
        if not filename.endswith(".gif"):
            filename = filename.rsplit(".", 1)[0] + ".gif"
        anim.save(filename, writer=animation.PillowWriter(fps=fps),
                  dpi=dpi)
    else:
        anim.save(filename, writer=animation.FFMpegWriter(fps=fps),
                  dpi=dpi)
    plt.close(fig)
    return filename


# ---------------------------------------------------------------- slicer
def slices(field, point=None, kind="intensity", logarithm=False,
           normalize=False, cut_value=None, cmap="inferno", output=None):
    """Static orthogonal-slice view through an (x, y, z) volume.
    ``point = (x0, y0, z0)`` physical
    coordinates of the slice intersection (default: the |field| max).
    Accepts a :class:`ScalarFieldXYZ` or a raw (nz, nx, ny) array.
    Returns (fig, (ax_xy, ax_zx, ax_zy))."""
    plt = _mpl()
    set_style()
    from .beam import ScalarFieldXYZ
    if isinstance(field, ScalarFieldXYZ):
        x, y, z = field.x, field.y, field.z
        u = _host(field.u)                   # (nz, nx, ny)
    else:
        u = _host(field)
        nz, nx, ny = u.shape
        x, y, z = np.arange(nx), np.arange(ny), np.arange(nz)
    img = field_view(u, kind, logarithm, normalize, cut_value)
    if point is None:
        iz, ix, iy = np.unravel_index(int(np.argmax(np.abs(img))),
                                      img.shape)
    else:
        x0, y0, z0 = point
        ix = int(np.argmin(np.abs(np.asarray(x) - x0)))
        iy = int(np.argmin(np.abs(np.asarray(y) - y0)))
        iz = int(np.argmin(np.abs(np.asarray(z) - z0)))

    fig, axs = plt.subplots(1, 3, figsize=(10.5, 3))
    panes = [
        (axs[0], x, y, img[iz].T, "x", "y",
         f"z = {float(np.asarray(z)[iz]):.3g}"),
        (axs[1], z, x, img[:, :, iy].T, "z", "x",
         f"y = {float(np.asarray(y)[iy]):.3g}"),
        (axs[2], z, y, img[:, ix, :].T, "z", "y",
         f"x = {float(np.asarray(x)[ix]):.3g}"),
    ]
    for a, h, v, im2d, hl, vl, ttl in panes:
        im = a.pcolormesh(np.asarray(h), np.asarray(v), im2d, cmap=cmap,
                          shading="auto")
        fig.colorbar(im, ax=a)
        a.set_xlabel(hl)
        a.set_ylabel(vl)
        a.set_title(ttl)
    fig.tight_layout()
    if output:
        fig.savefig(output)
        plt.close(fig)
    return fig, tuple(axs)
