"""The comparison that decides ``correct`` against its control and
planted faults, on small copies of the cells on the CPU: a sound run is
correct; the program at the nearest lower precision (complex64, its own
path), a step that returns its state unchanged, half of the 2DES batch
left out with the mean taken over the rest, and an answer altered where
it is produced each read false. The limits are the cells' own."""
import pytest
import torch

import small

CELLS = ["fmo_77k.pop", "fmo_77k.driven", "chain8_f2des.b256"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = small.run(cell)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_lower_precision_is_not_correct(cell):
    r = small.run(cell, dtype=torch.complex64)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, monkeypatch):
    from pyqed_tpu_torch.open.heom import HEOMSolver
    orig = HEOMSolver.rhs_fn

    def frozen(self, *a, **k):
        _, nado = orig(self, *a, **k)
        return (lambda y, *E: torch.zeros_like(y)), nado

    monkeypatch.setattr(HEOMSolver, "rhs_fn", frozen)
    assert small.run(cell)["correct"] is False


def test_half_the_2des_batch_left_out(monkeypatch):
    import pyqed_tpu_torch.signal.field2des as f2
    orig = f2.field_2des_rephasing

    def half(*a, n_phase=(4, 4), **k):
        # the second pulse's phases cut to half: half of the batch is
        # never run, and the phase-cycle mean is over the rest
        return orig(*a, n_phase=(n_phase[0], max(1, n_phase[1] // 2)), **k)

    monkeypatch.setattr(f2, "field_2des_rephasing", half)
    assert small.run("chain8_f2des.b256")["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, monkeypatch):
    if cell.startswith("chain8"):
        import pyqed_tpu_torch.signal.field2des as f2
        orig = f2.field_2des_rephasing

        def altered(*a, **k):
            P3, t1s, t3s = orig(*a, **k)
            P3 = P3.clone()
            P3[:, -1] *= 1 + 1e-6
            return P3, t1s, t3s

        monkeypatch.setattr(f2, "field_2des_rephasing", altered)
    else:
        from pyqed_tpu_torch.open.heom import HEOMSolver
        orig = HEOMSolver.run

        def altered(self, *a, **k):
            res = orig(self, *a, **k)
            res.observables[-1, 0] += 1e-6
            return res

        monkeypatch.setattr(HEOMSolver, "run", altered)
    assert small.run(cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_fault_after_the_first_job_is_not_correct(cell, monkeypatch):
    # state carried from one call to the next: every answer after the
    # warm-up and the window's first job is altered
    calls = []
    if cell.startswith("chain8"):
        import pyqed_tpu_torch.signal.field2des as f2
        orig = f2.field_2des_rephasing

        def carried(*a, **k):
            P3, t1s, t3s = orig(*a, **k)
            calls.append(1)
            return (P3 * (1 + 1e-6) if len(calls) > 2 else P3), t1s, t3s

        monkeypatch.setattr(f2, "field_2des_rephasing", carried)
    else:
        from pyqed_tpu_torch.open.heom import HEOMSolver
        orig = HEOMSolver.run

        def carried(self, *a, **k):
            res = orig(self, *a, **k)
            calls.append(1)
            if len(calls) > 2:
                res.observables[-1, 0] += 1e-6
            return res

        monkeypatch.setattr(HEOMSolver, "run", carried)
    r = small.run(cell, seconds=2.0)
    assert r["attempted"] >= 2
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("n, k", [(1, 1), (2, 1), (7, 1), (7, 3), (4, 9)])
def test_the_check_takes_the_last_job(n, k):
    import numpy as np

    from harness.cell import check_picks
    pick = check_picks(n, k, np.random.default_rng(n * 10 + k))
    assert pick[-1] == n - 1
    assert len(pick) == len(set(pick)) == min(k, n)
    assert pick == sorted(pick) and 0 <= pick[0]
