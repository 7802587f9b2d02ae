"""The port's evaluate_posteriorgrams reproduces the JAX package's app-level
accuracy goldens (tests/goldens/app_metrics_v1.npz) for every family and
every observation method, on the CPU: the inputs are
tests/test_app_goldens.py::_family_tracks's (the synthetic posteriorgram
tracks and the HMM parameters the apps' pipeline estimates), imported from
that test, and the tolerance is its own (atol 1e-6 on every pinned
metric; the accumulated OA against the mir_eval-semantics OA within 1e-6
a track)."""

import numpy as np
import pytest

from test_app_goldens import FAMILIES, GOLDEN, METHODS, PINNED, _family_tracks
from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch.harness.evaluate import DecoderSetup, evaluate_posteriorgrams

_TRACKS: dict = {}


def _evaluate(family: str, method: str) -> dict:
    if family not in _TRACKS:
        _TRACKS[family] = _family_tracks(family)
    spec, A, pi, tracks = _TRACKS[family]
    # _family_tracks's threshold rule (imm's is a log energy)
    threshold = 0.5 if not spec.threshold_is_logit else 0.0
    setup = DecoderSetup(
        transition_matrix=A, init_probs=pi, n_bins=spec.n_bins, note_min=spec.note_min,
        bins_per_semitone=spec.bins_per_semitone, spw=spec.spw, voicing_threshold=threshold,
        hop_seconds=spec.hop_seconds, method=method, threshold_is_logit=spec.threshold_is_logit,
        interp_est_notes=spec.interp_est_notes, device="cpu",
    )
    return evaluate_posteriorgrams(setup, tracks)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_port_reproduces_app_golden(family, method):
    golden = np.load(GOLDEN)
    res = _evaluate(family, method)
    assert max(abs(d) for d in res["cross_check_diff_viterbi"]) < 1e-6
    for path in ("raw", "viterbi"):
        for metric in PINNED:
            key = f"{family}/{method}/{path}/{metric}"
            np.testing.assert_allclose(np.asarray(res[path][metric], np.float64), golden[key],
                                       rtol=0, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(np.asarray(res["mir_eval_oas_viterbi"], np.float64),
                               golden[f"{family}/{method}/mir_eval_oas_viterbi"], rtol=0, atol=1e-6)
