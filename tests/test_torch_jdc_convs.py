"""The flags JDC's conv stack runs under (models/jdc.py): in eval mode cuDNN's
benchmark flag is on inside the stack alone, the caller's TF32 and
determinism kept, and every cuDNN flag is as the caller left it after the
forward, also when the forward raises; a training forward changes no
flag; a shape the stack meets first counts one conv_tunes. In eval mode
the stack runs the batch rounded up to a multiple of BATCH_STEP chunks,
and each chunk's outputs are exactly those of the batch as it is. On the CPU no
cuDNN runs, so the flags are read where the convolutions are called.
apps/common.py's float32_math, which TONet's path runs under, still leaves
the benchmark flag off."""

from __future__ import annotations

import pytest
import torch

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch import tracing
from viterbi_spl_tpu_torch.apps.common import float32_math
from viterbi_spl_tpu_torch.models import jdc as jdc_module
from viterbi_spl_tpu_torch.models.jdc import JDC

cudnn = torch.backends.cudnn
FLAGS = ("enabled", "benchmark", "deterministic", "allow_tf32")
# caller's flags unlike both cuDNN's defaults and what the conv stack sets
CALLER = {"enabled": True, "benchmark": False, "deterministic": True, "allow_tf32": False}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return JDC()


def chunks(n: int, frames: int = 4) -> torch.Tensor:
    """n chunks of `frames` frames (the stack takes any frame count; 513
    bins pool down to the pitch LSTM's 512 inputs)."""
    return torch.randn(n, frames, 513, generator=torch.Generator().manual_seed(n))


def flags() -> dict:
    return {k: getattr(cudnn, k) for k in FLAGS}


@pytest.fixture
def caller_flags():
    before = flags()
    with cudnn.flags(**CALLER):
        yield
    assert flags() == before


def watch_convs(model, monkeypatch):
    """The flags each convolution of the model is called under, in order,
    with the module's name."""
    calls = []
    for name, m in model.named_modules():
        if hasattr(m, "_conv"):
            conv = m._conv

            def watched(*args, _conv=conv, _name=name, **kwargs):
                calls.append((_name, flags()))
                return _conv(*args, **kwargs)

            monkeypatch.setattr(m, "_conv", watched)
    return calls


def test_eval_runs_the_conv_stack_with_benchmark_on_and_restores_the_flags(model, caller_flags,
                                                                           monkeypatch):
    calls = watch_convs(model, monkeypatch)
    with torch.no_grad():
        model.eval()(chunks(2))
    stack = [f for name, f in calls if name != "v_conv"]
    assert len(stack) == 11  # conv1_1, conv1_2 and three blocks of three
    assert all(f == dict(CALLER, benchmark=True) for f in stack), stack
    # the voicing head's 1x1 conv, after the stack, runs under the caller's flags
    assert [f for name, f in calls if name == "v_conv"] == [CALLER]
    assert flags() == CALLER


def test_the_flags_are_restored_when_the_forward_raises(model, caller_flags, monkeypatch):
    def broken(*args, **kwargs):
        assert cudnn.benchmark
        raise RuntimeError("block 3 failed")

    monkeypatch.setattr(model.block3, "forward", broken)
    with torch.no_grad(), pytest.raises(RuntimeError, match="block 3 failed"):
        model.eval()(chunks(2))
    assert flags() == CALLER


def test_training_enters_no_context_and_counts_nothing(caller_flags, monkeypatch):
    torch.manual_seed(1)
    model = JDC().train()
    calls = watch_convs(model, monkeypatch)
    entered = []
    monkeypatch.setattr(cudnn, "flags", lambda **kw: entered.append(kw))
    monkeypatch.setattr(jdc_module, "_MEASURED", set())
    tracing.clear()
    with tracing.enabled(), tracing.span("root"):
        model(chunks(3))
    spans = tracing.spans()
    tracing.clear()
    assert entered == [] and jdc_module._MEASURED == set()
    assert all(f == CALLER for _, f in calls) and len(calls) == 12
    assert all("conv_tunes" not in s.counts for s in spans)


def test_conv_tunes_counts_a_new_shape_once_and_a_repeated_shape_not_at_all(model, monkeypatch):
    monkeypatch.setattr(jdc_module, "_MEASURED", set())
    model.eval()

    def tunes(x) -> int:
        tracing.clear()
        with tracing.enabled(), torch.no_grad():
            model(x)
        spans = tracing.spans()
        tracing.clear()
        counted = [s for s in spans if "conv_tunes" in s.counts]
        assert all(s.name == "model.convs" for s in counted)
        return sum(s.counts["conv_tunes"] for s in counted)

    # 2 and 3 chunks run as a batch of 8, 9 as one of 16
    assert [tunes(chunks(2)), tunes(chunks(2)), tunes(chunks(3)), tunes(chunks(9)),
            tunes(chunks(2, frames=5))] == [1, 0, 0, 1, 1]
    # a shape met while nothing records is met all the same
    with torch.no_grad():
        model(chunks(4))
    assert tunes(chunks(4)) == 0
    assert "conv_tunes" in tracing.COUNTERS


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [13, 26, 42])
def test_the_rounded_up_batch_gives_each_chunk_exactly_its_own_outputs(n, dtype, monkeypatch):
    """A clip's 13, 26 or 42 chunks run as 16, 24 or 48 with zero chunks:
    the pitch logits and the voicing equal those of the batch as it is
    (BATCH_STEP 1), bit for bit."""
    torch.manual_seed(2)
    model = JDC(dtype=dtype).eval().to(dtype)
    x = chunks(n).to(dtype)
    with torch.no_grad():
        got = model(x)
        monkeypatch.setattr(jdc_module, "BATCH_STEP", 1)
        want = model(x)
    assert got["pitch"].shape == (n, 4, 722) and got["voicing"].shape == (n, 4)
    assert got["pitch"].dtype == dtype
    assert all(torch.equal(got[k], want[k]) for k in ("pitch", "voicing"))


def test_batch_statistics_and_training_keep_the_batch_as_it_is(monkeypatch):
    """Zero chunks would enter the batch's statistics: a forward under
    batch statistics, or in training mode, runs the batch it is given."""
    torch.manual_seed(3)
    model = JDC()
    x = chunks(5)
    batches = []
    forward = model.conv1_1.forward
    monkeypatch.setattr(model.conv1_1, "forward", lambda h, *a: batches.append(len(h)) or
                        forward(h, *a))
    with torch.no_grad():
        model.eval()(x, batch_stats=True)
        model.train()(x)
        model.eval()(x)
    assert batches == [5, 5, 8]


def test_float32_math_still_leaves_the_benchmark_flag_off():
    """TONet's (and every other model's) convolutions keep cuDNN's
    heuristic choice: float32_math sets benchmark off and TF32 off on a
    card, and restores the flags after."""
    before = flags()
    with cudnn.flags(enabled=True, benchmark=True, deterministic=False, allow_tf32=True):
        with float32_math("cuda"):
            inside = flags()
        assert flags() == dict(enabled=True, benchmark=True, deterministic=False,
                               allow_tf32=True)
    assert inside == dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=False)
    assert flags() == before
