"""Shared application template (counterpart of viterbi_spl_tpu/apps/common.py).

Reproduces the reference's per-script shape (Config -> AcousticModel ->
TFDataset(s) -> Metrics -> Model -> main() with training_fn/inference_fn,
e.g. dcnet/softmax_viterbi.py:3377-3602) on top of the harness:

- a synthetic-data factory standing in for the dataset roots (the same
  NumPy draws as the JAX package's),
- a train step (autograd; BatchNorm and dropout in training mode, the
  dropout generator seeded from the step; optional manual weight decay and
  l2 regularization; the training split's metric counts on the device),
- Adam under the family's learning-rate schedule,
- a validation pass producing the 99-point threshold grid and mean OA,
- the Trainer loop (early stopping + checkpoints + resume),
- `--mesh data=N[,model=M]`: the same step over a device mesh, the batch
  in N shares with the global batch's BatchNorm statistics and dropout
  masks, parameters and Adam's moments split over M with model=M
  (dist/train.py, dist/tp.py): the single-device loss curve at the same
  global batch,
- an inference pass running the dual raw/Viterbi evaluation with HMM
  parameters built on the fly from the validation labels (the decode:
  K1/K2 on the card, every NN family's matrix being banded).

Everything runs on CUDA unless `--device cpu` is passed. A model runs on the
device its params lie on. With the float32 compute dtype its convolutions
and matrix products, forward and backward, run in float32 on the card
(`float32_math`: TF32 off, as PyTorch leaves it on by default for cuDNN's
convolutions), so that its logits and gradients stay within float32
rounding of the CPU's and of the JAX package's.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from .. import tracing
from ..data import TrackDataset, training_snippets
from ..data.snippets import chunk_fixed, inference_snippets, snippet_index
from ..dist.mesh import make_mesh, mesh_device_list, parse_mesh_spec
from ..dist.tp import make_tp_mesh
from ..dist.train import MeshOptimizer
from ..families import FamilySpec
from ..harness.evaluate import DecoderSetup, evaluate_posteriorgrams
from ..harness.train import (
    Trainer,
    TrainState,
    add_weight_decay_grad,
    l2_regularization,
    split_state_dict,
)
from ..hmm import params as hmm_params
from ..metrics.mel_eval import midi_to_hz
from ..metrics.melody import MelodyMetrics, est_notes_interp, frame_counts
from ..models.layers import init_params
from ..utils import process_index, resolve_device


@dataclasses.dataclass
class AppConfig:
    family: FamilySpec
    make_model: Callable[..., torch.nn.Module]  # accepts dtype=... (compute dtype)
    loss_fn: Callable  # (notes, model output) -> 0-d tensor
    logits_adapter: Callable  # model output -> [B, T, n_bins] pitch logits
    snippet_len: int
    batch_size: int
    learning_rate: float
    feature_shape: tuple  # per-frame feature shape, e.g. (320, 3)
    # fixed-input models (ftanet/jdc/tonet) require exactly snippet_len
    # frames: inference zero-pads chunks (chunk_fixed) instead of serving a
    # ragged final snippet
    fixed_chunks: bool = False
    # inference normalizes with the track's own chunk-batch statistics
    # instead of the BN running averages (ftanet and tonet: their stacked
    # attention modules only function under per-batch normalization; see
    # the JAX package's AppConfig.eval_batch_stats). No dropout runs.
    eval_batch_stats: bool = False
    # transform from the [B, T, ...] snippet layout to the model's input
    # layout (tonet wants [B, 3, 360, T])
    input_adapter: Callable | None = None
    # mixed precision: compute dtype of the model's convs/denses/LSTMs
    # (params, BatchNorm statistics, losses and logits stay float32)
    compute_dtype: torch.dtype = torch.float32
    # the model takes a ragged final snippet (dcnet/msnet). The JAX package
    # bucket-pads and masks it (its compiled shapes); the port, running
    # eagerly, runs it at its own length, which is what the mask
    # reproduces
    supports_valid_frames: bool = False
    # manual weight decay on a single kernel: (param name, wd). The dcnet
    # rule — grad += wd * w on the global conv kernel only, every step
    # (dcnet/softmax_viterbi.py:293-364 + :3426)
    weight_decay: tuple | None = None
    # l2 regularization added to the training loss: (param names, scale).
    # The jdc kernels carry l2(1e-5) (jdc/acoustic_module.py:35,39,64)
    l2_reg: tuple | None = None
    # learning-rate schedule factory (base_lr, steps_per_epoch) -> fn of the
    # optimizer's update count (tonet's warm-up/decay,
    # tonet/model/tonet.py:474-490)
    lr_schedule: Callable | None = None
    # model output -> [B, T] voicing logits (jdc's combined voicing head,
    # jdc/acoustic_module.py:74-81). When set, the raw path's voicing
    # decision and the validation threshold grid score this head instead of
    # the peak pitch probability
    voicing_adapter: Callable | None = None


def float32_math(device) -> contextlib.AbstractContextManager:
    """float32 convolutions and matrix products on a CUDA device (no TF32);
    nothing to change on the CPU. cuDNN reads its flag at every call, so
    the context must hold over a backward pass too."""
    if torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.backends.cudnn.flags(enabled=True, allow_tf32=False))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    stack.callback(setattr, torch.backends.cuda.matmul, "allow_tf32", prev)
    return stack


def _model_math(cfg: AppConfig, device) -> contextlib.AbstractContextManager:
    low = cfg.compute_dtype in (torch.bfloat16, torch.float16)
    return contextlib.nullcontext() if low else float32_math(device)


def synthetic_dataset(cfg: AppConfig, n_tracks: int, frames: int, seed: int) -> TrackDataset:
    """Tiny synthetic tracks: wandering melody notes + noisy features that
    carry the label (a learnable mapping for smoke training); the JAX
    package's draws, in its order."""
    rng = np.random.default_rng(seed)
    spec_store: dict[str, np.ndarray] = {}
    label_store: dict[str, dict] = {}
    note_range = cfg.family.note_range
    n_bins = cfg.family.n_bins

    for i in range(n_tracks):
        tid = f"syn{i}"
        path = np.clip(
            n_bins // 2 + np.cumsum(rng.integers(-2, 3, frames)), 0, n_bins - 1
        )
        voiced = np.repeat(rng.random(frames // 20 + 1) > 0.25, 20)[:frames]
        notes = np.where(voiced, note_range[path], 0.0).astype(np.float32)
        feat = rng.normal(0, 0.3, (frames, *cfg.feature_shape)).astype(np.float32)
        # embed the label as a bump in the first feature channel
        bins = np.minimum(
            (path * cfg.feature_shape[0]) // n_bins, cfg.feature_shape[0] - 1
        )
        sel = (np.arange(frames), bins) + (0,) * (len(cfg.feature_shape) - 1)
        feat[sel] += np.where(voiced, 2.0, 0.0)
        freqs = np.where(notes > 0, midi_to_hz(notes), 0.0)
        spec_store[tid] = feat
        label_store[tid] = dict(
            notes=notes,
            original=dict(times=np.arange(frames) * cfg.family.hop_seconds,
                          freqs=freqs),
        )

    return TrackDataset(
        list(spec_store), lambda t: spec_store[t], lambda t: label_store[t]
    )


def init_model(cfg: AppConfig, model_kwargs: dict | None = None, seed: int = 0, device=None):
    """The family's model at the compute dtype, its params drawn with flax's
    initializers (models/layers.py) from a CPU torch.Generator seeded with
    `seed` (the same weights on every device), in eval mode on `device`
    (the CPU by default) -> (model, params, batch_stats)."""
    with torch.device("meta"):
        model = cfg.make_model(dtype=cfg.compute_dtype, **(model_kwargs or {}))
    model = model.to_empty(device="cpu")
    init_params(model, torch.Generator().manual_seed(seed))
    model = model.to(device or "cpu").eval()
    params, batch_stats = split_state_dict(model)
    return model, params, batch_stats


def load_state(model: torch.nn.Module, state: TrainState) -> None:
    """A TrainState's params and batch stats into the model (strict)."""
    model.load_state_dict({**state.params, **state.batch_stats}, strict=True)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _param_dtype(model) -> torch.dtype:
    return next(model.parameters()).dtype


def dropout_generator(step: int, device) -> torch.Generator:
    """The dropout masks' generator for one train step, on `device`, seeded
    from (1, step): every step draws fresh masks, the same ones for the same
    step (the counterpart of fold_in(PRNGKey(1), step))."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([1, step]).generate_state(1, np.uint64)[0]))
    return g


def _est_notes(spec: FamilySpec, peak_idx, probs):
    if spec is not None and not spec.interp_est_notes:
        # jdc maps bins to notes directly (viterbi_softmax.py:2471)
        n_bins = probs.shape[-1]
        grid = torch.arange(n_bins, dtype=torch.float32, device=probs.device) \
            / spec.bins_per_semitone + spec.note_min
        return grid[peak_idx]
    nm = spec.note_min if spec is not None else 0.0
    bps = spec.bins_per_semitone if spec is not None else 1.0
    return est_notes_interp(peak_idx, probs, nm, bps, probs.shape[-1])


def _peak_counts(spec: FamilySpec, ref, logits, voicing_logits, thresholds) -> dict:
    """frame_counts of one chunk's [T, n_bins] logits (and [T] voicing
    logits, when the family has a voicing head) against `thresholds`, on
    the logits' device."""
    probs = torch.sigmoid(logits.to(torch.float32))
    peak_idx = torch.argmax(probs, dim=1)
    if voicing_logits is not None:
        voicing_probs = torch.sigmoid(voicing_logits.to(torch.float32))
    else:
        voicing_probs = torch.gather(probs, 1, peak_idx[:, None])[:, 0]
    return frame_counts(ref, _est_notes(spec, peak_idx, probs), voicing_probs, thresholds)


def _step_counts(cfg: AppConfig, notes, out, threshold, thresholds: dict):
    """The training-split metric counts of one batch's output, on its
    device (None without a logits adapter); thresholds caches each
    (threshold, device)'s [1] tensor (the threshold changes once an
    epoch)."""
    if cfg.logits_adapter is None:
        return None
    with torch.no_grad():
        logits = cfg.logits_adapter(out)
        voicing = None if cfg.voicing_adapter is None else cfg.voicing_adapter(out)
        key = (threshold, notes.device)
        if key not in thresholds:
            thresholds[key] = torch.tensor([threshold], dtype=torch.float32,
                                           device=notes.device)
        return _peak_counts(
            cfg.family, notes.reshape(-1), logits.reshape(-1, logits.shape[-1]),
            None if voicing is None else voicing.reshape(-1), thresholds[key])


def make_train_step(cfg: AppConfig, model):
    """The train step for the Trainer: (params, batch_stats, optimizer,
    batch, step, threshold) -> (params, batch_stats, optimizer, loss,
    counts), `loss` on the device and `counts` the full
    training-split metric count dict computed on the device from this
    batch's logits (the reference accumulates VRR..OA over training
    batches every epoch, dcnet/softmax_viterbi.py:1599-1850). The model
    trains in place; after a step each param's .grad holds that step's
    gradient (weight decay included)."""
    dev = _device(model)
    pdtype = _param_dtype(model)
    thresholds = {}

    def train_step(params, batch_stats, opt_state, batch, step, threshold):
        spec, notes = batch
        spec = spec.to(dev, pdtype)
        notes = notes.to(dev)
        if cfg.input_adapter is not None:
            spec = cfg.input_adapter(spec)
        model.train()
        opt_state.zero_grad(set_to_none=True)
        # fresh dropout masks every step (the reference trains with
        # stochastic dropout, dcnet/softmax_viterbi.py:3399-3434)
        with _model_math(cfg, dev):
            out = model(spec, dropout=dropout_generator(step, dev))
            loss = cfg.loss_fn(notes, out)
            if cfg.l2_reg is not None:
                names, scale = cfg.l2_reg
                loss = loss + l2_regularization(params, names, scale)
            loss.backward()
        if cfg.weight_decay is not None:
            name, wd = cfg.weight_decay
            grads = add_weight_decay_grad({name: params[name].grad}, {name: params[name].detach()},
                                          name, wd)
            params[name].grad = grads[name]
        opt_state.step()
        counts = _step_counts(cfg, notes, out, threshold, thresholds)
        return params, batch_stats, opt_state, loss.detach(), counts

    return train_step


class ScheduledAdam(torch.optim.Adam):
    """torch.optim.Adam (its defaults are optax.adam's: b1 0.9, b2 0.999,
    eps 1e-8) whose learning rate for update k, k from 0 and Adam's own
    count (optax's), is schedule(k)."""

    def __init__(self, params, schedule: Callable[[int], float]):
        super().__init__(params, lr=float(schedule(0)))
        self.schedule = schedule

    def update_count(self) -> int:
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state.get(p)
                if st and "step" in st:
                    return int(st["step"])
        return 0

    def step(self, closure=None):
        lr = float(self.schedule(self.update_count()))
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def make_optimizer(cfg: AppConfig, model, steps_per_epoch: int, params=None) -> ScheduledAdam:
    """Adam over the model's trainable params (or over `params`: a mesh's
    shards), under the family's own LR schedule keyed by the optimizer's
    update count (tonet's warm-up/decay, tonet/model/tonet.py:474-490
    configure_optimizers), else at cfg.learning_rate."""
    if cfg.lr_schedule is not None:
        schedule = cfg.lr_schedule(cfg.learning_rate, steps_per_epoch)
    else:
        def schedule(k, lr=cfg.learning_rate):
            return lr
    if params is None:
        params = [p for p in model.parameters() if p.requires_grad]
    return ScheduledAdam(params, schedule)


def make_mesh_train_step(cfg: AppConfig, opt: MeshOptimizer):
    """make_train_step's step over a mesh (dist/train.py): the batch cut
    into one contiguous share a data row, each share's forward on its
    replica (the global batch's BatchNorm statistics and dropout masks),
    the loss the global mean (l2 regularization added once), one backward,
    then `opt.step`: the gradients summed over the shares, the weight decay
    and one Adam update, every replica refreshed. The counts are the
    shares' summed. params, batch_stats: replica 0's, which validation
    reads."""
    pdtype = _param_dtype(opt.replicas[0])
    thresholds = {}

    def train_step(params, batch_stats, opt_state, batch, step, threshold):
        opt_state.zero_grad(set_to_none=True)

        def share(i, model, item):
            dev = opt_state.devices[i]
            spec, notes = item[0].to(dev, pdtype), item[1].to(dev)
            if cfg.input_adapter is not None:
                spec = cfg.input_adapter(spec)
            out = model(spec, dropout=dropout_generator(step, dev))
            return cfg.loss_fn(notes, out), _step_counts(cfg, notes, out, threshold, thresholds)

        with _model_math(cfg, opt_state.devices[0]):
            outs = opt_state.run(share, opt_state.local_shares(*batch))
            loss = opt_state.share_mean([o[0] for o in outs])
            if cfg.l2_reg is not None and process_index() == 0:
                names, scale = cfg.l2_reg
                loss = loss + l2_regularization(params, names, scale)
            loss.backward()
        opt_state.step(weight_decay=cfg.weight_decay)
        counts = None
        if outs[0][1] is not None:
            counts = {k: opt_state.world_sum(sum(o[1][k].to(opt_state.devices[0]) for o in outs))
                      for k in outs[0][1]}
        return params, batch_stats, opt_state, opt_state.world_sum(loss.detach()), counts

    return train_step


def _forward(cfg: AppConfig, model, batch_stats: bool):
    """The inference forward: the input adapter, then the model without
    autograd, normalized by its running averages or (batch_stats, the
    apps' eval_batch_stats) by the batch's own statistics, running
    averages untouched and no dropout."""

    @torch.no_grad()
    def fwd(spec: np.ndarray):
        with tracing.span("model.upload"):
            x = tracing.upload(np.asarray(spec), _device(model), "model", _param_dtype(model))
        with tracing.span("model.forward"):
            if cfg.input_adapter is not None:
                x = cfg.input_adapter(x)
            return model(x, batch_stats=batch_stats)

    return fwd


def model_logits_for_dataset(cfg: AppConfig, model, dataset, with_voicing: bool = False):
    """Ordered inference over a dataset -> per-track pitch logits [T, n_bins]
    (float32 NumPy), with the weights the model holds.

    with_voicing=True returns (logits_list, voicing_list): per-track [T]
    voicing logits from the model's voicing head when the family has one
    (jdc's combined voicing output, jdc/acoustic_module.py:74-81), else
    None.

    Fixed-chunk models run a track's chunks together: in one batch under
    eval_batch_stats (the track's own statistics), else in batches of
    cfg.batch_size (each chunk independent, as the JAX package's one chunk
    at a time). Other models run one snippet at a time, a ragged last one
    at its own length. A `model` span (tracing.py)."""
    with tracing.span("model"):
        return _model_logits(cfg, model, dataset, with_voicing)


def _model_logits(cfg: AppConfig, model, dataset, with_voicing: bool):
    model.eval()
    want_voicing = with_voicing and cfg.voicing_adapter is not None

    def host(t):
        return tracing.to_host(t.to(torch.float32), "model").numpy()

    def split(out):
        lg = host(cfg.logits_adapter(out))
        v = host(cfg.voicing_adapter(out)) if want_voicing else None
        return lg, v

    def pack(logits_list, voicing_list):
        if not with_voicing:
            return logits_list
        return logits_list, (voicing_list if want_voicing else None)

    lg_list, v_list = [], []
    with _model_math(cfg, _device(model)):
        if cfg.fixed_chunks:
            fwd = _forward(cfg, model, batch_stats=cfg.eval_batch_stats)
            for track in dataset.tracks:
                chunks, _, T = chunk_fixed(track.spectrogram, track.notes, cfg.snippet_len)
                step = len(chunks) if cfg.eval_batch_stats else cfg.batch_size
                parts = [split(fwd(chunks[i:i + step])) for i in range(0, len(chunks), step)]
                lg = np.concatenate([p[0] for p in parts], axis=0)
                lg_list.append(lg.reshape(-1, lg.shape[-1])[:T])
                if want_voicing:
                    v_list.append(np.concatenate([p[1] for p in parts], axis=0).reshape(-1)[:T])
            return pack(lg_list, v_list)

        fwd = _forward(cfg, model, batch_stats=False)
        per_track: dict[int, list] = {}
        for item in inference_snippets(dataset, cfg.snippet_len):
            lg, v = split(fwd(item["spectrogram"][None]))
            per_track.setdefault(item["rec_idx"], []).append((lg[0], None if v is None else v[0]))
    for i in range(len(dataset)):
        T = dataset[i].num_frames
        lg_list.append(np.concatenate([p[0] for p in per_track[i]], axis=0)[:T])
        if want_voicing:
            v_list.append(np.concatenate([p[1] for p in per_track[i]], axis=0)[:T])
    return pack(lg_list, v_list)


def make_validate(cfg: AppConfig, model, dataset):
    """validate(state) -> dict(oa, voicing_threshold, results, rec_names):
    the 99-point voicing-threshold grid over the validation split, with the
    weights the model holds (the state's params are the model's), its
    counts on the model's device."""
    spec = cfg.family

    def validate(state: TrainState) -> dict:
        logits_list, voicing_list = model_logits_for_dataset(cfg, model, dataset,
                                                             with_voicing=True)
        dev = _device(model)
        mm = MelodyMetrics.validation_grid(len(dataset))
        thresholds = torch.as_tensor(mm.thresholds, device=dev)
        for rec_idx, logits in enumerate(logits_list):
            counts = _peak_counts(
                spec, torch.tensor(dataset[rec_idx].notes, device=dev),
                torch.as_tensor(logits, device=dev),
                None if voicing_list is None else torch.as_tensor(voicing_list[rec_idx], device=dev),
                thresholds)
            mm.update(rec_idx, {k: v.cpu().numpy() for k, v in counts.items()})
        idx, th = mm.best_voicing_threshold()
        results = mm.results(idx)
        return dict(
            oa=float(results["oa"].mean()),
            voicing_threshold=th,
            # full per-recording metric vectors at the selected threshold
            # (the per-epoch validation table, the reference's TBSummary
            # tables, dcnet/softmax_viterbi.py:3232-3355)
            results=results,
            rec_names=list(dataset.track_ids),
        )

    return validate


def build_decoder_setup(cfg: AppConfig, val_dataset, voicing_threshold: float,
                        method: str = "shaun", device=None) -> DecoderSetup:
    """HMM parameters from the validation labels (the reference's offline
    pipeline, SURVEY.md §3.5), then a DecoderSetup for this family on
    `device`."""
    spec = cfg.family
    note_max = float(spec.note_range[-1])
    q = [
        hmm_params.quantize_ref_notes(
            t.notes, spec.note_min, note_max, spec.bins_per_semitone, spec.n_bins
        )
        for t in val_dataset.tracks
    ]
    stats = hmm_params.count_statistics(q, spec.n_bins)
    A = hmm_params.shape_transition_matrix(
        stats.transition_counts, stats.switch, spec.n_bins,
        spec.d_max or 12, spec.floor or 2,
    )
    pi = hmm_params.shape_init_probs(stats.p_steady)
    return DecoderSetup(
        transition_matrix=A, init_probs=pi, n_bins=spec.n_bins,
        note_min=spec.note_min, bins_per_semitone=spec.bins_per_semitone,
        spw=spec.spw, voicing_threshold=voicing_threshold,
        hop_seconds=spec.hop_seconds, method=method,
        threshold_is_logit=spec.threshold_is_logit,
        interp_est_notes=spec.interp_est_notes, device=device,
    )


def tracks_for_evaluation(cfg: AppConfig, model, dataset) -> list[dict]:
    """Per-track evaluation inputs: pitch logits, reference notes, original
    (times, freqs), and — when the family has a voicing head — the model's
    per-frame voicing logits for the raw path's voicing decision."""
    logits_list, voicing_list = model_logits_for_dataset(cfg, model, dataset, with_voicing=True)
    tracks = []
    for i, (lg, track) in enumerate(zip(logits_list, dataset.tracks)):
        t = dict(
            logits=lg,
            notes=track.notes,
            original=dict(times=track.original_times, freqs=track.original_freqs),
        )
        if voicing_list is not None:
            t["voicing_logits"] = voicing_list[i]
        tracks.append(t)
    return tracks


def run_inference(cfg: AppConfig, model, dataset, setup) -> dict:
    return evaluate_posteriorgrams(setup, tracks_for_evaluation(cfg, model, dataset))


def app_main(cfg: AppConfig, build_real_datasets: Callable | None, argv=None,
             model_kwargs: dict | None = None,
             build_external_datasets: Callable | None = None):
    """The family app's CLI: train, infer, or a calibration mode, with the
    JAX package's modes and flags, and --device. model_kwargs: the model's
    constructor arguments, written into the checkpoint (tonet's --backbone
    and --mode). build_external_datasets(debug, device): the family's
    external evaluation corpora, for infer --external-eval."""
    ap = argparse.ArgumentParser(description=f"{cfg.family.name} app")
    ap.add_argument(
        "mode",
        choices=["train", "infer", "sweep-threshold", "hard-vs-auto", "sweep-obs"],
        help="train/infer, or the calibration experiments: sweep-threshold "
        "(ftanet/threshold.py, */determine_threshold*.py), hard-vs-auto "
        "(tonet/hard_thresholding_vs_automatic_thresholding.py), sweep-obs "
        "(tonet/hyper_parameter_selection.py)",
    )
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--ckpt", default=f"ckpts/{cfg.family.name}.pt",
                    help="the checkpoint file (harness/train.py)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--epochs", type=int, default=10_000)
    ap.add_argument("--steps-per-epoch", type=int, default=None)
    ap.add_argument("--patience", type=int, default=20)
    ap.add_argument("--viterbi-method", default="shaun")
    ap.add_argument("--hard-threshold", type=float, default=0.5,
                    help="fixed threshold for hard-vs-auto mode")
    ap.add_argument("--external-eval", action="store_true",
                    help="infer mode: additionally evaluate every external "
                         "corpus whose env root is set (adc04/mirex05/"
                         "mir1k/rwc — the reference evaluates each family "
                         "on all of them, dcnet/softmax_viterbi.py:860-1503)")
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--tensorboard", action="store_true",
                    help="mirror --log-dir scalars/tables into TensorBoard "
                         "event files (the reference's TBSummary surface)")
    ap.add_argument("--dump-tracks", default=None,
                    help="directory for per-track piano-roll figures + npz "
                         "dumps (the dcnet/lontano.py analysis outputs)")
    ap.add_argument("--native-prefetch", action="store_true",
                    help="train mode: assemble batches on the C++ prefetch "
                         "ring's threads (native/prefetch.py); datasets "
                         "with no full-length snippet use the Python "
                         "pipeline")
    ap.add_argument("--bf16", action="store_true",
                    help="mixed precision: run the model's convs/denses/"
                         "LSTMs in bfloat16; params, BatchNorm "
                         "statistics, losses, and logits stay float32")
    ap.add_argument("--mesh", default=None, metavar="data=N[,model=M]",
                    help="train mode: distributed training over an N*M-device "
                         "mesh: the batch shards over the 'data' axis (the "
                         "global batch's BatchNorm statistics) and, with "
                         "model=M, parameter/optimizer channel dims shard "
                         "over the 'model' axis (tensor parallelism, "
                         "dist/tp.py). N*M CUDA devices, or with --device cpu "
                         "N*M blocks of the CPU. Requires batch-size "
                         "divisible by N (raised if not). Same loss curve as "
                         "single-device at the same global batch (tested).")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    if args.bf16:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.bfloat16)
    mesh_sizes = parse_mesh_spec(args.mesh, axes=("data", "model")) if args.mesh else None
    dev = resolve_device(args.device)
    mesh = None
    if mesh_sizes is not None:
        n_data, n_model = mesh_sizes["data"], mesh_sizes["model"]
        devices = mesh_device_list(n_data * n_model, dev,
                                   f"--mesh data={n_data},model={n_model}")
        mesh = (make_tp_mesh(n_data, n_model, devices) if n_model > 1
                else make_mesh(data=n_data, devices=devices))
        if cfg.batch_size % n_data:
            new_bs = -(-cfg.batch_size // n_data) * n_data
            print(f"--mesh data={n_data}: raising batch size "
                  f"{cfg.batch_size} -> {new_bs} (must divide evenly)")
            cfg = dataclasses.replace(cfg, batch_size=new_bs)

    if args.synthetic:
        n, frames = (2, 400) if args.debug else (6, 2000)
        datasets = dict(
            training=synthetic_dataset(cfg, n, frames, 0),
            validation=synthetic_dataset(cfg, max(n // 2, 1), frames, 1),
            test=synthetic_dataset(cfg, max(n // 2, 1), frames, 2),
        )
    else:
        if build_real_datasets is None:
            raise SystemExit("real datasets not wired for this family yet")
        datasets = build_real_datasets(debug=args.debug, device=dev)

    steps_per_epoch = args.steps_per_epoch or max(len(datasets["training"]) * 4, 8)
    model, params, batch_stats = init_model(cfg, model_kwargs, seed=0, device=dev)
    if args.mode == "train" and mesh is not None:
        optimizer = MeshOptimizer(model, mesh, lambda ps: make_optimizer(
            cfg, None, steps_per_epoch, params=ps))
        step_fn = make_mesh_train_step(cfg, optimizer)
    else:
        optimizer = make_optimizer(cfg, model, steps_per_epoch)
        step_fn = make_train_step(cfg, model)
    state = TrainState(params=params, batch_stats=batch_stats, opt_state=optimizer)
    validate = make_validate(cfg, model, datasets["validation"])
    trainer = Trainer(
        step_fn, validate, ckpt_path=args.ckpt,
        patience_epochs=args.patience, max_epochs=args.epochs,
        family=cfg.family.name, model_kwargs=model_kwargs,
    )

    if args.mode == "train":
        return _train(cfg, args, trainer, state, datasets, steps_per_epoch, dev,
                      full_batches=mesh is not None)

    state = trainer.restore(state)
    setup = build_decoder_setup(
        cfg, datasets["validation"], state.voicing_threshold, args.viterbi_method, dev
    )

    if args.mode in ("sweep-threshold", "hard-vs-auto", "sweep-obs"):
        from .reports import run_calibration_mode

        return run_calibration_mode(
            args.mode, cfg, model, datasets, setup, hard_threshold=args.hard_threshold,
        )
    reporter = None
    if args.log_dir:
        from ..harness.reporting import Reporter

        reporter = Reporter(args.log_dir, tensorboard=args.tensorboard)

    eval_sets = {s: datasets[s] for s in ("validation", "test")}
    if args.external_eval:
        if build_external_datasets is None:
            raise SystemExit("external eval not wired for this family yet")
        external = build_external_datasets(debug=args.debug, device=dev)
        if not external:
            print("--external-eval: no external corpus roots set "
                  "(adc04/mirex05/mir1k/rwc)")
        eval_sets.update(external)

    outputs = dict(state=state)
    for split, dataset in eval_sets.items():
        out = run_inference(cfg, model, dataset, setup)
        outputs[split] = out
        print(
            f"{split}: raw OA {out['raw_mean_oa']:.4f}, "
            f"viterbi OA {out['viterbi_mean_oa']:.4f}"
        )
        if reporter is not None:
            names = list(dataset.track_ids)
            reporter.table(f"{split}/raw", out["raw"], names)
            reporter.table(f"{split}/viterbi", out["viterbi"], names)
        if args.dump_tracks and split == "test":
            dump_analysis_tracks(cfg, model, dataset, setup, args.dump_tracks)
    if reporter is not None:
        reporter.close()
    return outputs


def training_batches(cfg: AppConfig, dataset, rng: np.random.Generator, device,
                     native_prefetch: bool = False, full_batches: bool = False):
    """The training batch stream: batch_size snippets drawn from the
    shuffled snippet stream, the full-length ones kept (or the first, when
    none is full: --debug tracks are shorter than dcnet's and msnet's
    1,200-frame snippets), each batch as (spec, notes) tensors on
    `device` — the JAX app's stream, draw for draw. On a card the batch is
    staged in pinned memory and copied without waiting for the card.

    full_batches (a mesh's sharded batches): draws go on until the batch
    holds batch_size full-length snippets (the JAX app's redraw); a dataset
    without one exits, with the JAX app's message.

    native_prefetch: the batches come from the C++ prefetch ring
    (native/prefetch.py: full-length snippets only, in the same per-epoch
    permutation), as owned copies, which the pinned, non-blocking copy may
    outlive. A dataset with no full-length snippet falls back to the
    Python pipeline, with the JAX app's message."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def put(array):
        t = torch.from_numpy(array)
        return t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)

    if native_prefetch:
        from ..native.prefetch import SnippetPrefetcher

        try:
            prefetcher = SnippetPrefetcher(dataset, cfg.snippet_len, cfg.batch_size, rng)
        except ValueError as e:
            print(f"native prefetch unavailable ({e}); using the Python pipeline")
        else:
            return ((put(spec), put(notes)) for spec, notes in prefetcher)

    if full_batches and not any(e - s == cfg.snippet_len
                                for _, s, e in snippet_index(dataset, cfg.snippet_len)):
        raise SystemExit(f"--mesh: no track has {cfg.snippet_len} frames; "
                         "sharded batches need full-length snippets")

    def python_batches():
        snippets = training_snippets(dataset, cfg.snippet_len, rng)
        while True:
            raw = [next(snippets) for _ in range(cfg.batch_size)]
            items = [i for i in raw if len(i["notes"]) == cfg.snippet_len]
            if full_batches:
                while len(items) < cfg.batch_size:
                    it = next(snippets)
                    if len(it["notes"]) == cfg.snippet_len:
                        items.append(it)
            else:
                items = items or raw[:1]
            yield (put(np.stack([i["spectrogram"] for i in items])),
                   put(np.stack([i["notes"] for i in items])))

    return python_batches()


def _train(cfg, args, trainer, state, datasets, steps_per_epoch, dev, full_batches=False):
    batches = training_batches(cfg, datasets["training"], np.random.default_rng(0), dev,
                               native_prefetch=args.native_prefetch, full_batches=full_batches)
    reporter = None
    if args.log_dir:
        from ..harness.reporting import Reporter

        reporter = Reporter(args.log_dir, tensorboard=args.tensorboard)

    def on_epoch_end(st, info):
        if reporter is None:
            return
        reporter.scalar("train_loss", info["train_loss"], st.epoch)
        reporter.scalar("val_oa", info["val"]["oa"], st.epoch)
        reporter.scalar("voicing_threshold", st.voicing_threshold, st.epoch)
        reporter.scalar("train_steps", info["train_steps"], st.epoch)
        reporter.scalar("train_step_seconds", info["train_step_seconds"], st.epoch)
        # per-epoch training-split metric set + markdown tables (the
        # reference computes VRR..OA on training batches every epoch and
        # writes TB tables, dcnet/softmax_viterbi.py:1599-1850 + :3232-3355)
        tm = info.get("train_metrics")
        if tm is not None:
            for k in ("vrr", "vfa", "va", "rpa_strict", "rca_strict", "oa"):
                reporter.scalar(f"train_{k}", tm[k], st.epoch)
            reporter.table(
                "train", {k: np.asarray([v]) for k, v in tm.items() if k != "loss"},
                ["training"], step=st.epoch,
            )
        val = info["val"]
        if "results" in val:
            reporter.table("validation", val["results"], val["rec_names"], step=st.epoch)

    try:
        state = trainer.fit(state, batches, steps_per_epoch, resume=args.resume,
                            on_epoch_end=on_epoch_end)
    finally:
        if reporter is not None:
            reporter.close()
    # report + return the CHECKPOINTED state, not the final-epoch one:
    # fit() keeps training past the best epoch until patience fires, so
    # state.voicing_threshold here is the LAST epoch's grid pick. The
    # reference checkpoints the threshold variable with the best-OA
    # checkpoint (dcnet/softmax_viterbi.py:2179-2207) and that is what
    # inference uses — restore it so train-mode output matches.
    state = trainer.restore(state)
    print(f"best val OA {state.best_oa:.4f} @ epoch {state.best_epoch}, "
          f"threshold {state.voicing_threshold:.2f}")
    return state


def dump_analysis_tracks(cfg, model, dataset, setup, out_dir):
    """Per-track reference/viterbi/raw piano-roll figures + npz dumps — the
    analysis layer (dcnet/lontano.py effect_of_viterbi_fn, nn_problem.py)."""
    from ..harness.evaluate import decode_and_score_track
    from ..harness.reporting import dump_track_npz, piano_roll_figure

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    logits_list, voicing_list = model_logits_for_dataset(cfg, model, dataset, with_voicing=True)
    for i, (track, logits) in enumerate(zip(dataset.tracks, logits_list)):
        r = decode_and_score_track(
            setup, logits, track.notes,
            voicing_logits=None if voicing_list is None else voicing_list[i],
        )
        piano_roll_figure(
            out / f"{track.track_id}.png",
            track.notes,
            r["est_notes_viterbi"], r["viterbi_voiced"],
            r["est_notes_raw"], r["raw_voiced"],
            title=track.track_id,
        )
        dump_track_npz(
            out / f"{cfg.family.name}_{track.track_id}.npz",
            ref_notes=track.notes,
            viterbi_notes=r["est_notes_viterbi"],
            viterbi_voicing=r["viterbi_voiced"],
            raw_notes=r["est_notes_raw"],
            raw_voicing=r["raw_voiced"],
            viterbi_bins=r["viterbi_bins"],
        )


# the 8 kHz families estimate on the 10 ms grid: their labels are resampled
# to it
TEN_MS_FAMILIES = ("ftanet", "jdc", "tonet")


def medleydb_datasets(family: str, debug: bool = False, device=None,
                      labels: str = "m2m3") -> dict[str, TrackDataset]:
    """The real MedleyDB splits through the family's front-end on `device`
    (cli/transcribe.py::features_from_samples, the chain a transcribed wav
    sees), with MELODY2 + vocal-section labels, resampled to the 10 ms grid
    for the 8 kHz families; labels="yu" reads Yu's precomputed 10 ms f0
    references instead (tonet/main_shaun.py:386-406). The roots come from
    the environment (data/registry.py::dataset_roots: medleydb,
    melody2_dir, section_dir, fatnet_spec). --debug keeps 2 tracks a
    split."""
    import os

    from ..cli.transcribe import FAMILY_SR, features_from_samples
    from ..data import medleydb_splits
    from ..data.labels import medleydb_label, resample_notes_to_10ms, tonet_f0ref_label
    from ..data.vocals import is_vocals_from_sections
    from ..io.wav import load_wav

    ten_ms = family in TEN_MS_FAMILIES

    def spec_fn(tid):
        wav = os.path.join(os.environ["medleydb"], tid, tid + "_MIX.wav")
        return features_from_samples(family, load_wav(wav, sr=FAMILY_SR[family])[0],
                                     device=device)

    def label_fn(tid):
        lb = medleydb_label(tid, is_vocals_from_sections(tid))
        if ten_ms:
            lb["notes"] = resample_notes_to_10ms(lb["notes"])
        return lb

    splits = medleydb_splits()
    if debug:
        splits = {k: v[:2] for k, v in splits.items()}
    return {
        name: TrackDataset(tids, spec_fn, tonet_f0ref_label if labels == "yu" else label_fn,
                           max_length_diff=2 if ten_ms else 1)
        for name, tids in splits.items()
    }


def external_datasets(family: str, debug: bool = False, device=None) -> dict[str, TrackDataset]:
    """The external evaluation corpora (adc04/mirex05/mir1k/rwc, whichever
    roots are set) through the family's front-end on `device`
    (cli/transcribe.py::features_from_samples, as `medleydb_datasets`), at
    the family's sample rate, with 10 ms labels for the 8 kHz families:
    each family's build_external_datasets."""
    from ..cli.transcribe import FAMILY_SR, features_from_samples

    return build_external_eval_datasets(
        lambda samples: features_from_samples(family, samples, device=device),
        sr=FAMILY_SR[family], labels_on_10ms=family in TEN_MS_FAMILIES, debug=debug,
    )


def build_external_eval_datasets(
    spec_fn: Callable[[np.ndarray], np.ndarray],
    sr: int,
    labels_on_10ms: bool = False,
    debug: bool = False,
    corpora: tuple[str, ...] | None = None,
) -> dict[str, TrackDataset]:
    """Evaluation datasets beyond MedleyDB (the reference evaluates every
    family on adc04/mirex05/mir1k/rwc as well; dcnet/softmax_viterbi.py
    §TFDatasetForAdc04.. ForRWC). `spec_fn` maps raw samples (at `sr`) to
    features; labels are resampled to 10 ms when the family uses that hop.
    Only corpora whose env-var roots are set are returned; `corpora`
    restricts the set (the imm harness evaluates adc04/mirex05/mir1k but
    not rwc, imm/main_imm.py). The readers and the resampling are the JAX
    package's, in NumPy; `spec_fn` computes where it will (the families'
    front-ends on their device)."""
    import os
    import wave
    from math import gcd

    def wanted(name):
        return corpora is None or name in corpora

    from ..data import adc04_track_ids, mir1k_track_ids, mirex05_track_ids
    from ..data.labels import (
        adc04_label,
        mir1k_label,
        mirex05_label,
        resample_notes_to_10ms,
        rwc_label,
        rwc_rec_files,
    )
    from ..io.wav import load_aiff, load_wav, resample_poly

    def maybe_10ms(lb):
        if labels_on_10ms:
            lb["notes"] = resample_notes_to_10ms(lb["notes"])
        return lb

    out: dict[str, TrackDataset] = {}

    if wanted("adc04") and os.environ.get("adc04"):
        tids = adc04_track_ids()[: 2 if debug else None]
        root = os.environ["adc04"]
        out["adc04"] = TrackDataset(
            tids,
            lambda t: spec_fn(load_wav(os.path.join(root, t + ".wav"), sr=sr)[0]),
            lambda t: maybe_10ms(adc04_label(t)),
            max_length_diff=2,
        )

    if wanted("mirex05") and os.environ.get("mirex05"):
        tids = mirex05_track_ids()[: 2 if debug else None]
        root = os.environ["mirex05"]
        out["mirex05"] = TrackDataset(
            tids,
            lambda t: spec_fn(load_wav(os.path.join(root, t + ".wav"), sr=sr)[0]),
            lambda t: maybe_10ms(mirex05_label(t)),
            max_length_diff=2,
            # the reference pads whichever side is short for mirex05
            # (dcnet/main.py:1055-1060)
            pad_short_notes=True,
        )

    if wanted("mir1k") and os.environ.get("mir1k"):
        root = os.environ["mir1k"]
        tids = mir1k_track_ids()[: 2 if debug else None]

        def mir1k_lb(t):
            with wave.open(
                os.path.join(root, "Wavfile", t + ".wav"), "rb"
            ) as fh:
                n = fh.getnframes()
            return maybe_10ms(mir1k_label(t, n))

        out["mir1k"] = TrackDataset(
            tids,
            lambda t: spec_fn(
                load_wav(os.path.join(root, "Wavfile", t + ".wav"), sr=sr)[0]
            ),
            mir1k_lb,
            max_length_diff=2,
            # the .pv grid undershoots the audio; the reference zero-pads
            # short labels for mir1k (dcnet/softmax_viterbi.py:1262-1268)
            pad_short_notes=True,
        )

    if wanted("rwc") and os.environ.get("rwc"):
        rec_files = rwc_rec_files()
        n = 2 if debug else len(rec_files)

        def rwc_spec(t):
            samples, file_sr = load_aiff(rec_files[int(t)])
            if file_sr != sr:
                g = gcd(sr, file_sr)
                samples = resample_poly(samples, sr // g, file_sr // g).astype(
                    np.float32
                )
            return spec_fn(samples)

        def rwc_lb(t):
            samples, file_sr = load_aiff(rec_files[int(t)])
            frames_10ms = (len(samples) + file_sr // 100 - 1) // (file_sr // 100)
            return maybe_10ms(rwc_label(int(t), frames_10ms))

        out["rwc"] = TrackDataset(
            [str(i) for i in range(n)], rwc_spec, rwc_lb, max_length_diff=2,
            # the reference zero-pads notes when they undershoot by one
            # frame (dcnet/main.py:1507-1512)
            pad_short_notes=True,
        )

    return out
