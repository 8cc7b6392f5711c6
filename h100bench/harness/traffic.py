"""The one traffic generator: a traffic file's ``draws`` give the inputs
of each job, drawn from the run's seed and the job's index, so that the
same seed gives the same jobs and every job has the same sizes.

A draw is ``{"dist": ..., "size": ...}`` with ``dist``

- ``unit_complex``: a complex vector of standard normals, normalised;
- ``normal``: ``mean`` + ``std`` N(0, 1), element-wise.

A string in place of a number (``size``, ``mean``, ``std``) names a key
of the configuration that holds it.
"""
from __future__ import annotations

import itertools

import numpy as np

DISTS = ("unit_complex", "normal")


def _value(v, cfg):
    return cfg[v] if isinstance(v, str) else v


def draw(rng, spec, cfg):
    size = int(_value(spec["size"], cfg))
    dist = spec["dist"]
    if dist == "unit_complex":
        v = rng.standard_normal(size) + 1j * rng.standard_normal(size)
        return v / np.linalg.norm(v)
    if dist == "normal":
        return (float(_value(spec["mean"], cfg))
                + float(_value(spec["std"], cfg)) * rng.standard_normal(size))
    raise ValueError(f"traffic: unknown distribution {dist!r}; expected one "
                     f"of {DISTS}")


def job(traffic, cfg, seed, index):
    """Job ``index`` of the run with ``seed``: its index and its draws.
    Index -1 is the warm-up job, drawn apart from the timed ones."""
    rng = np.random.default_rng([int(seed) % (1 << 64), index + 1])
    out = {"index": index}
    for name, spec in traffic.get("draws", {}).items():
        out[name] = draw(rng, spec, cfg)
    return out


def jobs(traffic, cfg, seed):
    """Jobs 0, 1, 2, ... of the run with ``seed``."""
    for i in itertools.count():
        yield job(traffic, cfg, seed, i)
