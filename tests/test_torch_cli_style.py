"""Parity of the PyTorch port's command line (cli.py) and plotting
wrappers (utils/style.py) with the JAX package, on the CPU.

``run_job`` runs the same four JSON job specs (sesolve, lindblad, heom,
spo) through both packages (the port with ``device="cpu"``), and the NPZ
arrays both write are compared: rel 1e-10 (max abs difference over the
reference's max abs). The subcommands ``test``, ``bench`` and ``run`` run
on the CPU on request and raise without a card by default. Every style
wrapper saves one plot under ``tmp_path`` (Agg); ``export`` writes the
same text as JAX's and ``read_result`` loads both packages' NPZ. Importing
the port, its beam layer and its CLI does not import matplotlib.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyqed_tpu import cli as jcli
from pyqed_tpu.utils import style as jstyle

import pyqed_tpu_torch as pt
from pyqed_tpu_torch import cli as tcli
from pyqed_tpu_torch.utils import style as tstyle

RTOL = 1e-10

JOBS = {
    "sesolve": {"task": "sesolve", "complex_pairs": True,
                "H": [[[0.0, 0.0], [0.05, 0.02]], [[0.05, -0.02], [0.3, 0.0]]],
                "psi0": [[1.0, 0.0], [0.0, 0.0]],
                "e_ops": [[[[0.0, 0.0], [0.0, 0.0]], [[0.0, 0.0], [1.0, 0.0]]]],
                "dt": 0.02, "nt": 400, "nout": 20},
    "lindblad": {"task": "lindblad", "H": [[0.5, 0.1], [0.1, -0.5]],
                 "rho0": [[0.0, 0.0], [0.0, 1.0]],
                 "c_ops": [[[0.0, 0.4472135954999579], [0.0, 0.0]]],
                 "e_ops": [[[0.0, 0.0], [0.0, 1.0]],
                           [[0.0, 1.0], [1.0, 0.0]]],
                 "dt": 0.01, "nt": 300, "nout": 10},
    "heom": {"task": "heom", "H": [[0.0, 0.1], [0.1, 0.2]],
             "coupling": [[1.0, 0.0], [0.0, -1.0]],
             "rho0": [[1.0, 0.0], [0.0, 0.0]],
             "bath": {"temperature": 1.0, "cutoff": 1.0, "reorg": 0.05},
             "lmax": 3, "nexp": 2, "e_ops": [[[1.0, 0.0], [0.0, 0.0]]],
             "dt": 0.05, "nt": 200, "nout": 20},
    "spo": {"task": "spo", "grid": {"xmin": -10.0, "xmax": 10.0, "n": 128},
            "mass": 1.0, "potential": "0.5*x**2 + 0.1*np.sin(x)",
            "psi0": "np.exp(-(x-1.0)**2/2)", "dt": 0.01, "nt": 200,
            "nout": 20},
}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Each job spec's file and the JAX package's NPZ of it."""
    d = tmp_path_factory.mktemp("jobs")
    out = {}
    for name, spec in JOBS.items():
        path = d / f"{name}.json"
        path.write_text(json.dumps(spec))
        ref = d / f"{name}_jax.npz"
        jcli.run_job(str(path), str(ref))
        out[name] = (path, dict(np.load(ref, allow_pickle=True)), ref)
    return out


@pytest.mark.parametrize("name", list(JOBS))
def test_run_job_matches_jax(jobs, name, tmp_path):
    path, ref, _ = jobs[name]
    out = tmp_path / "port.npz"
    tcli.run_job(str(path), str(out), device="cpu")
    got = dict(np.load(out))
    arrays = [k for k in ("times", "observables", "states", "psi", "rho",
                          "ado") if k in ref]
    assert "times" in arrays and len(arrays) >= 2
    for k in arrays:
        assert k in got, k
        assert rel(got[k], ref[k]) <= RTOL, (name, k)


def test_main_subcommands_run_on_request_and_need_the_card(jobs, tmp_path,
                                                           capsys):
    path, ref, _ = jobs["lindblad"]
    out = tmp_path / "cli.npz"
    assert tcli.main(["run", str(path), "-o", str(out), "--device",
                      "cpu"]) == 0
    assert rel(np.load(out)["observables"], ref["observables"]) <= RTOL
    assert tcli.main(["test", "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["ok"] and line["max_err"] < 1e-6
    line = tcli.bench_heom(12, device="cpu", nout=4)
    assert line["bench"] == "heom_fmo_flagship" and line["steps_per_s"] > 0
    assert line["device"] == "cpu"
    json.dumps(line)
    assert tcli.main(["info"]) == 0
    assert "torch" in capsys.readouterr().out
    if not torch.cuda.is_available():
        for argv in (["run", str(path)], ["test"], ["bench"]):
            with pytest.raises(RuntimeError, match="cuda"):
                tcli.main(argv)


def test_style_plots_save(tmp_path):
    x = np.linspace(-2.0, 2.0, 30)
    y = np.linspace(-1.0, 1.0, 20)
    f = torch.as_tensor(np.exp(-np.add.outer(x ** 2, 2 * y ** 2)))
    calls = [
        lambda p: tstyle.curve(x, np.stack([np.sin(x), np.cos(x)], 1),
                               "x", "y", output=p),
        lambda p: tstyle.curve(torch.as_tensor(x), torch.sin(
            torch.as_tensor(x)), output=p, ax=tstyle.subplots()[1]),
        lambda p: tstyle.matplot(x, y, f, output=p, contour=True),
        lambda p: tstyle.matplot(x, y, f - 0.5, output=p, diverge=True),
        lambda p: tstyle.imshow(x, y, f, output=p),
        lambda p: tstyle.level_scheme(torch.as_tensor([0.0, 1.0, 1.5]),
                                      ylim=(-1, 2), fname=p),
        lambda p: tstyle.two_scales(x, np.sin(x), np.cos(x), "x",
                                    ("a", "b"), output=p),
        lambda p: tstyle.surf(x, y, f, fname=p, zlabel="f"),
        lambda p: tstyle.plot_surface(x, y, f, fname=p),
        lambda p: tstyle.plot_surfaces(x, y, [f, f * 0.5], fname=p)]
    for i, call in enumerate(calls):
        p = tmp_path / f"s{i}.png"
        call(str(p))
        assert p.stat().st_size > 0, i
    tstyle.set_style(10)


def test_export_and_read_result_match_jax(jobs, tmp_path):
    x = np.linspace(0.0, 1.0, 5)
    y = np.linspace(-1.0, 1.0, 3)
    z = np.add.outer(x, y ** 2)
    for args, kw in (((x, np.stack([x, x ** 2], 1)), {}),
                     ((x, y, z), {}), ((x, y, z), {"fmt": "plain"})):
        pj, pt_ = tmp_path / "j.dat", tmp_path / "t.dat"
        jstyle.export(*args, fname=str(pj), **kw)
        tstyle.export(*(torch.as_tensor(a) for a in args), fname=str(pt_),
                      **kw)
        assert pt_.read_text() == pj.read_text()
    res = pt.Result(times=torch.linspace(0, 1, 4, dtype=torch.float64),
                    observables=torch.ones(4, 2, dtype=torch.complex128),
                    dt=0.25)
    res.dump(str(tmp_path / "r.npz"))
    back = tstyle.read_result(str(tmp_path / "r.npz"))
    assert torch.equal(back.times, res.times) and back.dt == 0.25
    assert pt.read_result is tstyle.read_result
    _, ref, ref_path = jobs["heom"]
    jres = tstyle.read_result(str(ref_path))
    assert rel(jres.observables.numpy(), ref["observables"]) == 0.0


def test_import_does_not_load_matplotlib():
    code = ("import sys, pyqed_tpu_torch, pyqed_tpu_torch.beam, "
            "pyqed_tpu_torch.cli, pyqed_tpu_torch.utils.style; "
            "import pyqed_tpu_torch.beam.drawing; "
            "f = pyqed_tpu_torch.beam.ScalarFieldXYZ("
            "[0., 1., 2., 3.], [0., 1., 2., 3.], [1., 2.], 0.5, device='cpu');"
            "f.incident_field([[1.0] * 4] * 4).bpm(); "
            "assert 'matplotlib' not in sys.modules, 'matplotlib imported'")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
