"""Small copies of the cells, for the CPU: the same files with their
sizes cut (depth of the hierarchy, steps, the 2DES batch)."""
from harness import registry


def cell(name):
    """(spec, cfg, traffic) of a small copy of cell ``name``."""
    spec = registry.benchmark()
    w = registry.workload(spec, name)
    cfg = registry.config(spec, w["config"])
    traffic = registry.data("traffic", w["traffic"])
    if cfg["system"] == "fmo":
        cfg.update(lmax=2, nexp=1)
        traffic.update(nt=40, nout=10)
    else:
        cfg.update(n_sites=3, lmax=2)
        traffic.update(n_t1=3, nt3=8, t1_step=0.2, n_phase=[2, 2])
    return spec, cfg, traffic


def run(name, seed=2 ** 31 + 77, seconds=0.2, **kw):
    """A run of the small copy on the CPU."""
    from harness.cell import run_cell
    spec, cfg, traffic = cell(name)
    kw.setdefault("cfg", cfg)
    kw.setdefault("traffic", traffic)
    return run_cell(spec, name, seed, seconds, device="cpu", **kw)
