"""Observation models: acoustic-model logits -> HMM observation probabilities,
in PyTorch on the caller's device (counterpart of viterbi_spl_tpu/hmm/obs.py).

- "shaun" (the paper's model): local-peak picking with single-side width spw
  + logistic voicing probability; reference dcnet/softmax_viterbi.py:2316-2360
  (spw=5, 320 bins), jdc/viterbi_softmax.py:1959-2003 (spw=16, 721 bins),
  imm/main_imm.py:187-234 (spw=20, 721 bins, log-energy threshold).
- softmax-scaled / softmax-unscaled: softmax over peaks (divided by state
  priors when scaled); reference dcnet/softmax_viterbi.py:2530-2579,
  jdc/viterbi_softmax.py:2131-2176.

Peak finding uses reflect padding + windowed first-argmax, matching
np.pad(mode='reflect') / first-max argmax semantics of the reference; the
masks are exact. The probabilities agree with the JAX package's to a few
float32 ulps (exp and the denominators' summation order differ between
XLA and PyTorch).

Observation probabilities are returned TIME-major [T, S+1] with the unvoiced
state last.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing


def find_peaks(logits: torch.Tensor, spw: int) -> torch.Tensor:
    """Boolean peak mask per frame.

    logits: [T, n_bins]. A bin is a peak iff it is the FIRST maximum of the
    window of width 2*spw+1 centred on it (reflect-padded at the edges) —
    i.e. strictly greater than every entry to its left and >= every entry
    to its right. Both side maxima are slices of one running window max of
    width spw, built by shift doubling (exact: max is associative).
    """
    n_bins = logits.shape[-1]
    idx = np.pad(np.arange(n_bins), spw, mode="reflect")
    padded = logits[:, tracing.upload(idx, logits.device, "decode_service")]
    m, k = padded, 1
    while k < spw:
        s = min(k, spw - k)
        m = torch.maximum(m[:, : m.shape[1] - s], m[:, s:])
        k += s
    # m[i] = max(padded[i .. i+spw-1])
    left = m[:, 0:n_bins]
    right = m[:, spw + 1 : spw + 1 + n_bins]
    return (logits > left) & (logits >= right)


def shaun_observation_probs(
    logits: torch.Tensor,
    threshold: float,
    spw: int,
    p: float = 0.8,
    scale: float = 2.0,
) -> torch.Tensor:
    """The paper's peak+voicing observation model, fully vectorized.

    logits: [T, n_bins] frame-wise pitch logits (sigmoid logits for dcnet,
    re-referenced softmax logits for msnet/ftanet/tonet, log-energies for imm).
    threshold: voicing threshold in logit/log-energy units.

    Per frame: find peaks; p_voiced = expit(scale*(gmax - th) +/- offset)
    with offset = log(p/(1-p)), sign flipping at gmax >= th; softmax mass over
    peaks scaled to p_voiced; unvoiced state gets 1 - p_voiced; frames with no
    peaks are fully unvoiced.

    Returns [T, n_bins + 1] with unvoiced last; rows sum to 1.
    """
    logits = logits.to(torch.float32)
    dev = logits.device
    threshold = tracing.upload(threshold, dev, "decode_service", torch.float32)
    p = tracing.upload(p, dev, "decode_service", torch.float32)
    offset = torch.log(p / (1.0 - p))
    scale = tracing.upload(scale, dev, "decode_service", torch.float32)

    is_peak = find_peaks(logits, spw)
    any_peak = is_peak.any(dim=1)  # [T]

    peak_logits = torch.where(is_peak, logits, -torch.inf)
    gmax = peak_logits.amax(dim=1)  # [T]; -inf when no peaks
    sign = torch.where(gmax >= threshold, 1.0, -1.0)
    s = scale * (gmax - threshold) + sign * offset
    p_voiced = torch.where(any_peak, torch.sigmoid(s), 0.0)

    # softmax over peaks, scaled so the voiced mass is p_voiced
    exps = torch.where(is_peak, torch.exp(logits - gmax[:, None]), 0.0)
    denom = exps.sum(dim=1, keepdim=True)
    voiced_probs = exps * (p_voiced[:, None] / torch.clamp(denom, min=1e-30))

    unvoiced = (1.0 - p_voiced)[:, None]
    return torch.cat([voiced_probs, unvoiced], dim=1)


def softmax_observation_probs(
    logits: torch.Tensor,
    voicing_threshold_logit: float,
    init_probs,
    spw: int,
    scaled: bool,
) -> torch.Tensor:
    """Softmax observation model (the SoftMaxViterbi ablation).

    logits: [T, n_bins] pitch logits already re-referenced to the non-melody
    class where applicable. The non-melody "bin" takes the constant logit
    log(th/(1-th)); it always counts as a peak. Softmax over the peak set,
    then (scaled=True) divided by the state priors (likelihood = posterior /
    prior). Reference: dcnet/softmax_viterbi.py:2530-2579.

    init_probs: [n_bins + 1] priors with unvoiced LAST.
    Returns [T, n_bins + 1] observation weights with unvoiced last. Rows are
    NOT normalized when scaled (only ratios matter to Viterbi).
    """
    logits = logits.to(torch.float32)
    dev = logits.device
    n_bins = logits.shape[1]
    vth = tracing.upload(voicing_threshold_logit, dev, "decode_service", torch.float32)

    if scaled:
        priors = tracing.upload(np.asarray(init_probs, np.float32), dev, "decode_service")
    else:
        priors = torch.ones((n_bins + 1,), dtype=torch.float32, device=dev)
    prior_unvoiced = priors[-1]
    prior_voiced = priors[:-1]

    is_peak = find_peaks(logits, spw)

    # softmax over {non-melody logit} ∪ {peak logits}
    peak_logits = torch.where(is_peak, logits, -torch.inf)
    gmax = torch.maximum(peak_logits.amax(dim=1), vth)  # non-melody always in set
    exps = torch.where(is_peak, torch.exp(logits - gmax[:, None]), 0.0)
    exp_nm = torch.exp(vth - gmax)  # [T]
    denom = exps.sum(dim=1) + exp_nm

    voiced = exps / denom[:, None] / prior_voiced[None, :]
    voiced = torch.where(is_peak, voiced, 0.0)
    unvoiced = (exp_nm / denom) / prior_unvoiced

    # frames with no pitch peaks: all mass on the non-melody state
    any_peak = is_peak.any(dim=1)
    voiced = torch.where(any_peak[:, None], voiced, 0.0)
    unvoiced = torch.where(any_peak, unvoiced, 1.0 / prior_unvoiced)

    return torch.cat([voiced, unvoiced[:, None]], dim=1)


def rereference_softmax_logits(logits: torch.Tensor) -> torch.Tensor:
    """Pitch logits re-referenced to the non-melody class: logits[:, 1:] -
    logits[:, :1] (reference msnet/hsieh_m2m3.py:1895,
    ftanet/viterbi_performance.py:2058, jdc/viterbi_softmax.py:2452-2453)."""
    return logits[:, 1:] - logits[:, :1]
