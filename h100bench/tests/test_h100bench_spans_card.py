"""On the card: the program's spans lie on the clock of the device trace.
A span around a sleeping kernel (``torch.cuda._sleep``, ATen's
``spin_kernel``) and a ``synchronize()`` holds the kernel's interval from
``torch.profiler`` (CUDA activity alone, as the harness traces a window;
the sleeps are its only device events) in every try, and the kernel
starts within 100 us of its span. The session's first kernel is a
warm-up outside the spans: the first launch under the profiler started
up to 418 us after its span on an H100 (torch 2.11). On that card the
test failed in 9 of 20 sessions: the first try's kernel started up to
142 us after its span, or the profiler's device stamps sat off the
host's clock by an offset constant within the session (kernels up to 26
us, in a third call once 0.59 ms, before their span). Run on a machine
with a CUDA card from the root of a checkout: ``python -m pytest
h100bench/tests -q -m card``."""
import statistics

import pytest
import torch

from harness import trace as tr
from pyqed_tpu_torch.core.diagnostics import span, start_spans, stop_spans

TRIES = 100
CYCLES = 200_000        # about 0.1 ms at 1.98 GHz


@pytest.mark.card
def test_spans_hold_their_kernels_on_the_device_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        torch.cuda._sleep(CYCLES)
        torch.cuda.synchronize()
        start_spans()
        for _ in range(TRIES):
            with span("sleep"):
                torch.cuda._sleep(CYCLES)
                torch.cuda.synchronize()
        spans = stop_spans()
    events = tr.device_events(prof)
    kernels = sorted((s, e) for _, s, e in events)[1:]
    assert len(kernels) == len(spans) == TRIES, {n for n, _, _ in events}
    lead = [k[0] - s.start_ns for k, s in zip(kernels, spans)]
    tail = [s.end_ns - k[1] for k, s in zip(kernels, spans)]
    bad = [(i, lead[i], tail[i]) for i in range(TRIES)
           if not (0 <= lead[i] <= 100_000 and tail[i] >= 0)]
    assert not bad, (
        f"kernel start after span start {min(lead)} .. {max(lead)} ns "
        f"(median {statistics.median(lead)}), span end after kernel end "
        f"{min(tail)} .. {max(tail)} ns; {len(bad)} of {TRIES} tries "
        f"fail, (try, lead ns, tail ns): {bad[:10]}")
