"""Dense Viterbi kernels and the decode APIs (counterpart of
viterbi_spl_tpu/hmm/viterbi_pallas.py).

K3 (forward) and K4 (backtrace) decode batches of tracks; K7 (forward) and
K8 (backtrace) decode windows of one track, each with its own length, reset
row and start state (the single-track kernels of the JAX package, which the
sequence-parallel decode runs over its time blocks). All four are CUDA C++,
K7/K8 in csrc/viterbi_window.cu, K4 in csrc/viterbi_dense.cu, and K3 on
K7's kernel with every reset row 0 (its own cluster kernel in
csrc/viterbi_dense.cu above 768 states), each with its plain PyTorch
version here. The forwards store no backpointers:
they write the shifted rows t1m1[:, t] = T1[t-1] (row 0 zeros), and the
backtrace rebuilds each pointer as the first-max argmax of
t1m1[t] + logB[s_t, :] — the very row the forward step reduced, so paths
are bit-identical to storing backpointers, and to the NumPy oracle. On the
card K8 rebuilds every pointer of a window in one parallel pass before its
chase (window_backpointers_plain is that pass's plain version).

`viterbi_decode_batch_logobs` keeps the dispatch of the JAX package's
`viterbi_decode_batch_pallas_logobs`: the banded forward (K1) when the
transition matrix has the shaped melody structure, else the dense forward
(K3); the first-max argmax of t1_last; the banded backtrace (K2) when the
structure carries source-profile classes, else the dense backtrace (K4).
PyTorch runs eagerly, so there is no shape bucketing and no padding of N
or S.

`viterbi_decode_batch_fused_obs` is the serving path from raw logits: the
forward with the observation model inside it (K9) when the structure is
banded, else the observation kernel (K5/K6) and the dense decode.

The batch decode APIs take their tables from one prepared HMM per
(transition matrix, initial probabilities) (hmm/prepared.py): host tables
built once, their card copies uploaded once a device. A call uploads only
its lengths, once, before its first kernel, and both kernels read that
copy; after the forward is launched, nothing on the host waits for the
card until the caller reads the states (unless k2_route must read the last
states).

With `mesh` (dist/mesh.py), the batch decode APIs split the tracks over the
mesh's "data" devices and run the same dispatch on each device's share,
each device with its own card copies. `viterbi_decode` is the single-track
decode over K7 -> K8.

Each batch decode API is a `decode` span (tracing.py; attrs tracks, real
frames, states, route) holding `decode.prepare` (the prepared HMM's
lookup, counted as tables_reused, or its build, counted as tables_built),
`decode.stage` (viterbi_decode_batch's per-track copies), `decode.forward`
(with the lengths' upload, a `decode.wait`), `decode.route` (the first-max
argmax and K2's route, with a `decode.wait` where the route reads the
card) and `decode.backtrace`; over a mesh, each share is a `decode` span
of its own.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_lib, tracing
from ..utils import on_device, resolve_device
from . import obs_fused
from .prepared import PreparedHMM, prepared_hmm
from .viterbi import first_argmax, log_obs_fn, prepare_log_params
from .viterbi_banded import banded_backtrace, banded_forward, banded_forward_obs, k2_route


def window_forward_plain(log_B, log_pi, log_obs, lengths, reset_rows):
    """K7's plain version, the single-track forward of
    viterbi_pallas.py::_forward_kernel over a batch of windows: log_B
    [S, S], log_pi [S], log_obs [N, W, S], lengths [N] (1 <= T <= W) and
    reset_rows [N] (-1 <= r < T) -> (t1_last [N, S] = T1 at frame T - 1,
    t1m1 [N, W, S] with t1m1[:, t] = T1[t - 1], row 0 zeros). Frame 0
    starts from log_pi + obs when the reset row is 0 and from obs alone (a
    cold start) otherwise; at frame t == reset row the carry restarts from
    log_pi + obs[t], overriding the DP step; frames at or beyond T keep the
    carry."""
    N, W, S = log_obs.shape
    dev = log_obs.device
    lengths = torch.as_tensor(lengths, device=dev)[:, None]
    reset = torch.as_tensor(reset_rows, device=dev)[:, None]
    log_B, log_pi = log_B.to(dev), log_pi.to(dev)[None, :]
    prev = torch.where(reset == 0, log_pi + log_obs[:, 0], log_obs[:, 0])
    t1m1 = torch.zeros_like(log_obs)
    for t in range(1, W):
        t1m1[:, t] = prev
        m = (prev[:, None, :] + log_B[None]).amax(dim=2)
        new = torch.where(t == reset, log_pi + log_obs[:, t], m + log_obs[:, t])
        prev = torch.where(t < lengths, new, prev)
    return prev, t1m1


def window_backtrace_plain(log_B, t1m1, start_states, lengths):
    """K8's plain version, the chase of viterbi_pallas.py::_backtrace_kernel
    over a batch of windows: from start_states[n] at frame lengths[n] - 1,
    s_{t-1} = first-argmax(t1m1[t] + log_B[s_t]). Returns states [N, W]
    int32; entries at or beyond each window's length are zeros."""
    N, W, S = t1m1.shape
    dev = t1m1.device
    log_B = log_B.to(dev)
    lengths = torch.as_tensor(lengths, device=dev)
    s = torch.as_tensor(start_states, device=dev).to(torch.int64)
    states = torch.zeros((N, W), dtype=torch.int32, device=dev)
    for t in range(W - 1, -1, -1):
        active = t < lengths
        states[:, t] = torch.where(active, s, 0).to(torch.int32)
        bp = first_argmax(t1m1[:, t] + log_B[s], dim=1)
        s = torch.where(active, bp, s)
    return states


def window_backpointers_plain(log_B, t1m1, lengths):
    """The plain version of K8's backpointer pass: bp[n, t, s] =
    first-argmax_x(t1m1[n, t, x] + log_B[s, x]) for 1 <= t < lengths[n],
    zeros elsewhere; [N, W, S] int32. Chasing s_{t-1} = bp[n, t, s_t] from
    a start state gives window_backtrace_plain's states."""
    N, W, S = t1m1.shape
    lengths = torch.as_tensor(lengths, device=t1m1.device)
    bp = torch.zeros((N, W, S), dtype=torch.int32, device=t1m1.device)
    log_B = log_B.to(t1m1.device)
    for t in range(1, W):
        cand = t1m1[:, t, None, :] + log_B[None]  # [N, S targets, S sources]
        bp[:, t] = torch.where((t < lengths)[:, None], first_argmax(cand, dim=2), 0).to(torch.int32)
    return bp


def dense_forward_plain(log_B, log_pi, log_obs, lengths):
    """K3's plain version: log_B [S, S] (= log(A.T + tiny)), log_pi [S],
    log_obs [N, T, S], lengths [N] -> (t1_last [N, S], t1m1 [N, T, S]).
    K7's with every reset row 0 (K3 and K7 compute one DP)."""
    return window_forward_plain(log_B, log_pi, log_obs, lengths, np.zeros(log_obs.shape[0], np.int32))


# K4's plain version -> states [N, T] int32 (zeros at or beyond each
# track's length): K8's chase from each track's last state
dense_backtrace_plain = window_backtrace_plain


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vspl_dense_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vspl_dense_backtrace": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vspl_dense_backtrace_residency": [_I, _P],
}
_WINDOW_SIGNATURES = {
    "vspl_window_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vspl_dense_forward_window": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vspl_window_max_clusters": [_I, _P],
    "vspl_window_backtrace": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "vspl_window_cluster_size": [_I],
}


# K3's routes: K7's kernel with every reset row 0 ("window": the table slice
# in registers, rows signalled by arrival, up to K7_MAX_STATES states), or
# the cluster kernel of csrc/viterbi_dense.cu ("cluster": the table streamed
# from L2 every frame, any S)
DENSE_ROUTES = ("window", "cluster")
K7_MAX_STATES = 768


def k3_route(S: int) -> str:
    """K3's route at S states: "window" while K7's kernel takes S, else
    "cluster"."""
    return "window" if S <= K7_MAX_STATES else "cluster"


# A frame of K7's kernel with G tracks a cluster takes about 1 + 0.7 (G - 1)
# times one with one track (the slice in registers serves all G rows; the
# exchange overlaps): 1.79, 2.49, 3.33 at 361 states and 1.65, 2.33, 3.0 at
# 722 for G = 2, 3, 4 (scripts/gpu_dense_probe.py; PERF.md).
K3_TRACK_COST = 0.7


def k3_tracks_per_cluster(N: int, clusters: int) -> int:
    """Tracks each of K3's window clusters decodes (1-4), for N tracks on a
    card that holds `clusters` of K7's clusters at once: the G that
    minimises the waves, ceil(ceil(N / G) / clusters), times a frame's cost
    at G tracks, 1 + K3_TRACK_COST (G - 1); the fewer tracks on a tie."""
    def cost(G):
        return -(-(-(-N // G)) // max(clusters, 1)) * (1 + K3_TRACK_COST * (G - 1))
    return min((1, 2, 3, 4), key=lambda G: (cost(G), G))


_MAX_CLUSTERS: dict = {}


def window_max_clusters(S: int) -> int:
    """How many of K7's clusters (one window each) the card holds at once at
    S states (cudaOccupancyMaxActiveClusters; builds the kernel's library)."""
    if S not in _MAX_CLUSTERS:
        lib = cuda_lib.load("viterbi_window", _WINDOW_SIGNATURES)
        out = ctypes.c_int(0)
        cuda_lib.check(lib, lib.vspl_window_max_clusters(S, ctypes.byref(out)),
                       "K7 cluster occupancy")
        _MAX_CLUSTERS[S] = out.value
    return _MAX_CLUSTERS[S]


def dense_forward(log_B, log_pi, log_obs: torch.Tensor, lengths, route: str | None = None,
                  tracks: int | None = None, lens_d=None):
    """K3: dense batched forward DP. Same contract as dense_forward_plain;
    on the GPU, rows of t1m1 at or beyond a track's length are left
    unwritten. route: "window" or "cluster" (DENSE_ROUTES); None takes
    k3_route's. tracks: the window route's tracks a cluster (1-4); None
    takes k3_tracks_per_cluster's. On the card, log_B and log_pi are
    uploaded unless there already, and lens_d (the lengths as an int32
    tensor there, the same values) is taken where given."""
    N, T, S = log_obs.shape
    lens = cuda_lib.host_lengths(lengths, N, T)
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    log_pi = torch.as_tensor(log_pi, dtype=torch.float32)
    if log_B.shape != (S, S) or log_pi.shape != (S,):
        raise ValueError(f"bad shapes log_B={tuple(log_B.shape)} log_pi={tuple(log_pi.shape)}")
    if route not in (None, *DENSE_ROUTES):
        raise ValueError(f"K3 has the routes {DENSE_ROUTES}, not {route!r}")
    if log_obs.device.type == "cpu":
        return dense_forward_plain(log_B, log_pi, log_obs, lens)
    dev = cuda_lib.cuda_operand(log_obs, "log_obs").device
    route = route or k3_route(S)
    log_B = tracing.upload(log_B, dev, "decode")
    log_pi = tracing.upload(log_pi, dev, "decode").contiguous()
    lens_d = cuda_lib.card_lengths(lens, dev, lens_d)
    t1m1 = torch.empty_like(log_obs)
    t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
    P = cuda_lib.ptr
    if route == "window":
        if S > K7_MAX_STATES:
            raise ValueError(f"K3's window route takes at most {K7_MAX_STATES} states, not {S}")
        lib = cuda_lib.load("viterbi_window", _WINDOW_SIGNATURES)
        G = k3_tracks_per_cluster(N, window_max_clusters(S)) if tracks is None else tracks
        rc = lib.vspl_dense_forward_window(
            P(log_obs), P(log_B.to(dev).contiguous()), P(log_pi), P(lens_d), P(t1m1),
            P(t1_last), N, T, S, G, cuda_lib.stream_ptr(dev),
        )
    else:
        lib = cuda_lib.load("viterbi_dense", _SIGNATURES)
        log_A = log_B.to(dev).t().contiguous()  # log_A[s', s] = log_B[s, s']
        rc = lib.vspl_dense_forward(
            P(log_obs), P(log_A), P(log_pi), P(lens_d), P(t1m1), P(t1_last),
            N, T, S, cuda_lib.stream_ptr(dev),
        )
    cuda_lib.check(lib, rc, f"dense forward (K3, {route} route)")
    dense_forward.launches += 1
    return t1_last, t1m1


# K4 chases each track in segments of at least K4_MIN_SEGMENT frames, one
# warp each, every segment's chase starting K4_WARMUP frames above it
# (csrc/viterbi_dense.cu; scripts/gpu_dense_probe.py --parts k4seg, PERF.md)
K4_MIN_SEGMENT = 64
K4_WARMUP = 32


def k4_segment_length(N: int, T: int, resident: int) -> int:
    """Frames in each of K4's segments for N tracks of at most T frames on a
    card that holds `resident` of its segment warps at once: as many
    segments a track as fill the card in one wave, but none shorter than
    K4_MIN_SEGMENT frames (T itself: one segment, the plain chain)."""
    K = max(1, min(resident // max(N, 1), T // K4_MIN_SEGMENT))
    return -(-T // K)


_RESIDENT: dict = {}


def dense_backtrace_resident(S: int) -> int:
    """K4's segment warps the card holds at once at S states (SMs times the
    warps an SM holds, cudaOccupancyMaxActiveBlocksPerMultiprocessor;
    builds the kernel's library)."""
    if S not in _RESIDENT:
        lib = cuda_lib.load("viterbi_dense", _SIGNATURES)
        out = ctypes.c_int(0)
        cuda_lib.check(lib, lib.vspl_dense_backtrace_residency(S, ctypes.byref(out)),
                       "K4 residency")
        _RESIDENT[S] = out.value * torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return _RESIDENT[S]


def dense_backtrace(log_B, t1m1: torch.Tensor, last_states, lengths, segment: int | None = None,
                    warmup: int = K4_WARMUP, fixups: torch.Tensor | None = None, lens_d=None):
    """K4: dense batched reverse chase. Returns states [N, T] int32;
    entries at or beyond each track's length are unspecified. On the card
    each track is chased in segments of `segment` frames (None:
    k4_segment_length's; T or more: one segment, the plain chain), each
    segment's chase starting `warmup` frames above it, then the seams made
    exact (two kernels, one counted launch). fixups: an int32 [N] CUDA
    tensor that receives the frames each track's seams re-chased. log_B
    and lens_d: as dense_forward's."""
    N, T, S = t1m1.shape
    lens = cuda_lib.host_lengths(lengths, N, T)
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    if log_B.shape != (S, S):
        raise ValueError(f"log_B must be [{S}, {S}], got {tuple(log_B.shape)}")
    if (segment is not None and segment < 1) or warmup < 0:
        raise ValueError(f"segment must be >= 1 and warmup >= 0, got {segment}, {warmup}")
    if t1m1.device.type == "cpu":
        return dense_backtrace_plain(log_B, t1m1, last_states, lens)
    dev = cuda_lib.cuda_operand(t1m1, "t1m1").device
    if fixups is not None:
        cuda_lib.cuda_operand(fixups, "fixups", torch.int32)
        if fixups.shape != (N,):
            raise ValueError(f"fixups must be [N={N}], got {tuple(fixups.shape)}")
    L = min(segment or k4_segment_length(N, T, dense_backtrace_resident(S)), T)
    log_B = tracing.upload(log_B, dev, "decode").contiguous()
    last = torch.as_tensor(last_states).to(dev, torch.int32).contiguous()
    lens_d = cuda_lib.card_lengths(lens, dev, lens_d)
    states = torch.empty((N, T), dtype=torch.int32, device=dev)
    pred = torch.empty((N, -(-T // L)), dtype=torch.int32, device=dev)
    lib = cuda_lib.load("viterbi_dense", _SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_dense_backtrace(
        P(t1m1), P(log_B), P(last), P(lens_d), P(states), P(pred),
        None if fixups is None else P(fixups), N, T, S, L, warmup, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "dense backtrace (K4)")
    dense_backtrace.launches += 1
    return states


def window_forward(log_B, log_pi, log_obs: torch.Tensor, lengths, reset_rows):
    """K7: the dense forward over a batch of windows of one track, each with
    its own length and reset row, in one launch (one cluster per window: 8
    blocks up to 384 states, 16 up to 768, the kernel's limit). Same
    contract as window_forward_plain; on the GPU, rows of t1m1 at or beyond
    a window's length are left unwritten."""
    N, W, S = log_obs.shape
    lens = cuda_lib.host_lengths(lengths, N, W)
    reset = np.asarray(reset_rows, np.int32)
    if reset.shape != (N,) or (reset < -1).any() or (reset >= lens).any():
        raise ValueError(f"reset_rows must be [N={N}] in [-1, length), got {reset}")
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    log_pi = torch.as_tensor(log_pi, dtype=torch.float32)
    if log_B.shape != (S, S) or log_pi.shape != (S,):
        raise ValueError(f"bad shapes log_B={tuple(log_B.shape)} log_pi={tuple(log_pi.shape)}")
    if log_obs.device.type == "cpu":
        return window_forward_plain(log_B, log_pi, log_obs, lens, reset)
    dev = cuda_lib.cuda_operand(log_obs, "log_obs").device
    log_B = log_B.to(dev).contiguous()
    log_pi = log_pi.to(dev).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    reset_d = torch.as_tensor(reset, device=dev)
    t1m1 = torch.empty_like(log_obs)
    t1_last = torch.empty((N, S), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("viterbi_window", _WINDOW_SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_window_forward(
        P(log_obs), P(log_B), P(log_pi), P(lens_d), P(reset_d), P(t1m1), P(t1_last),
        N, W, S, cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "window forward (K7)")
    window_forward.launches += 1
    return t1_last, t1m1


def window_cluster_size(S: int) -> int:
    """Blocks in each of K7's thread-block clusters at S states (the
    kernel's fixed rule; builds the kernel's library)."""
    return cuda_lib.load("viterbi_window", _WINDOW_SIGNATURES).vspl_window_cluster_size(S)


def window_backtrace(log_B, t1m1: torch.Tensor, start_states, lengths):
    """K8: the chase over a batch of windows, each from its own start state
    at its last frame: on the card a parallel pass writes every backpointer
    of every window into a scratch [N, W, S rounded up to 4] int32, then one
    thread per window chases them (two kernels, one counted launch).
    Returns states [N, W] int32; entries at or beyond each window's length
    are unspecified."""
    N, W, S = t1m1.shape
    lens = cuda_lib.host_lengths(lengths, N, W)
    log_B = torch.as_tensor(log_B, dtype=torch.float32)
    if log_B.shape != (S, S):
        raise ValueError(f"log_B must be [{S}, {S}], got {tuple(log_B.shape)}")
    if t1m1.device.type == "cpu":
        return window_backtrace_plain(log_B, t1m1, start_states, lens)
    dev = cuda_lib.cuda_operand(t1m1, "t1m1").device
    log_B = log_B.to(dev).contiguous()
    start = torch.as_tensor(start_states).to(dev, torch.int32).contiguous()
    lens_d = torch.as_tensor(lens, device=dev)
    states = torch.empty((N, W), dtype=torch.int32, device=dev)
    bp = torch.empty((N, W, -(-S // 4) * 4), dtype=torch.int32, device=dev)
    lib = cuda_lib.load("viterbi_window", _WINDOW_SIGNATURES)
    P = cuda_lib.ptr
    rc = lib.vspl_window_backtrace(
        P(t1m1), P(log_B), P(start), P(lens_d), P(states), P(bp), N, W, S,
        cuda_lib.stream_ptr(dev),
    )
    cuda_lib.check(lib, rc, "window backtrace (K8)")
    window_backtrace.launches += 1
    return states


dense_forward.launches = 0
dense_backtrace.launches = 0
window_forward.launches = 0
window_backtrace.launches = 0

# every kernel wrapper of the decode path, by kernel id
KERNEL_WRAPPERS = {
    "K1": banded_forward,
    "K2": banded_backtrace,
    "K3": dense_forward,
    "K4": dense_backtrace,
    "K5": obs_fused.shaun_log_obs,
    "K6": obs_fused.softmax_log_obs,
    "K7": window_forward,
    "K8": window_backtrace,
    "K9": banded_forward_obs,
}


def counted_launches(fn, *args, **kwargs):
    """(fn(*args, **kwargs), {kernel id: launches it made, where any}): the
    wrappers' own counts (each adds one where it launches its kernel on the
    card; none on the CPU)."""
    before = {k: w.launches for k, w in KERNEL_WRAPPERS.items()}
    out = fn(*args, **kwargs)
    made = {k: w.launches - before[k] for k, w in KERNEL_WRAPPERS.items()}
    return out, {k: n for k, n in made.items() if n}


def viterbi_forward(log_B, log_pi, log_obs: torch.Tensor, T: int, reset_row: int = 0):
    """Single-track forward (counterpart of viterbi_forward_pallas, without
    its lane and frame padding): log_obs [W, S] with T <= W real frames ->
    (t1_last [S], t1m1 [W, S]). reset_row: 0 for an ordinary decode, -1 for
    a cold start, else the frame whose carry restarts from log_pi + obs.
    K7 on the GPU."""
    t1_last, t1m1 = window_forward(log_B, log_pi, log_obs[None], [T], [reset_row])
    return t1_last[0], t1m1[0]


def viterbi_backtrace(t1m1: torch.Tensor, log_B, last_state, T: int) -> torch.Tensor:
    """Single-track chase (counterpart of viterbi_backtrace_pallas): states
    [W] int32 from last_state at frame T - 1; entries at or beyond T are
    unspecified. K8 on the GPU."""
    start = torch.as_tensor(last_state).reshape(1)
    return window_backtrace(log_B, t1m1[None], start, [T])[0]


def viterbi_decode(*, transition_matrix, prob_init, probs_st, device=None) -> np.ndarray:
    """Single-track decode with the oracle's signature (counterpart of
    viterbi_decode_pallas): probs_st [S, T] -> [T] int64 states, K7 -> the
    first-max argmax -> K8 on the GPU."""
    dev = resolve_device(device)
    log_B, log_pi = prepare_log_params(transition_matrix, prob_init)
    probs = torch.as_tensor(np.asarray(probs_st, np.float32)).to(dev)
    T = probs.shape[1]
    t1_last, t1m1 = viterbi_forward(log_B, log_pi, log_obs_fn(probs.T.contiguous()), T)
    states = viterbi_backtrace(t1m1, log_B, torch.argmax(t1_last), T)
    return states.cpu().numpy().astype(np.int64)


def decode_over_data(mesh, batch: torch.Tensor, lengths, decode) -> torch.Tensor:
    """decode(share, share_lengths) on each "data" device's share of the
    batch (contiguous shares, the first N % D one track longer, as
    torch.tensor_split cuts them; a device with no track gets none); the
    states gathered back on the batch's device. On a mesh that spans
    processes, each process decodes only its own devices' shares and
    returns their states, the tracks `dist.mesh.local_tracks` names."""
    lengths = cuda_lib.host_lengths(lengths, batch.shape[0], batch.shape[1])
    devices = mesh.axis_devices("data")
    outs = [torch.empty((0, batch.shape[1]), dtype=torch.int32, device=batch.device)]
    for i, (dev, idx) in enumerate(zip(devices, np.array_split(np.arange(batch.shape[0]),
                                                               len(devices)))):
        if len(idx) and mesh.is_local(i):
            share = slice(int(idx[0]), int(idx[-1]) + 1)
            with on_device(dev):
                outs.append(decode(batch[share].to(dev), lengths[share]).to(batch.device))
    return torch.cat(outs, dim=0)


def _prepare(transition_matrix, prob_init, hmm) -> PreparedHMM:
    """The decode APIs' `decode.prepare` span: the prepared HMM's lookup
    (prepared.prepared_hmm, `hmm` the caller's hint), or its build."""
    with tracing.span("decode.prepare"):
        return prepared_hmm(transition_matrix, prob_init, hmm)


def _in_decode_span(fn, hmm: PreparedHMM, **kwargs):
    """fn(hmm, share, share_lengths, span, **kwargs) in a `decode` span of
    its own, for decode_over_data's shares."""
    def decode(x, lens):
        with tracing.span("decode") as sp:
            return fn(hmm, x, lens, sp, **kwargs)
    return decode


def _route_and_backtrace(hmm: PreparedHMM, card, t1_last, t1m1, lengths: np.ndarray, lens_d,
                         sp) -> torch.Tensor:
    """The first-max argmax of t1_last, then K2 (its route chosen here) when
    the structure carries source-profile classes, else K4: the
    `decode.route` and `decode.backtrace` spans of the decode APIs, for the
    host lengths of cuda_lib.host_lengths and their copy on the card."""
    N, T, S = t1m1.shape
    bstruct = hmm.banded
    with tracing.span("decode.route"):
        # first maximum, as np.argmax (documented for torch.argmax)
        last_states = torch.argmax(t1_last[:, :S], dim=1).to(torch.int32)
        banded = bstruct is not None and bstruct.classes
        route = k2_route(bstruct, N, T, last_states) if banded and t1m1.is_cuda else None
    if sp:
        sp.set(tracks=N, frames=int(lengths.sum()), states=S,
               route=(route or "plain") if banded else "dense")
    with tracing.span("decode.backtrace"):
        if banded:
            return banded_backtrace(bstruct, t1m1, last_states, lengths, route=route,
                                    profiles=card.profiles, lens_d=lens_d)
        return dense_backtrace(card.log_B, t1m1, last_states, lengths, lens_d=lens_d)


def _decode_logobs(hmm: PreparedHMM, log_obs: torch.Tensor, lengths, sp) -> torch.Tensor:
    """K1 -> K2 (K3 -> K4 without a band) on one device, the lengths
    uploaded once before K1."""
    N, T, S = log_obs.shape
    if S != hmm.S:
        raise ValueError(f"log_obs has {S} states, the matrix {hmm.S}")
    with tracing.span("decode.forward"):
        card = hmm.card(log_obs.device)
        lengths = cuda_lib.host_lengths(lengths, N, T)
        lens_d = tracing.upload(lengths, log_obs.device, "decode")
        if hmm.banded is not None:
            t1_last, t1m1 = banded_forward(hmm.banded, card.log_pi, log_obs, lengths,
                                           profiles=card.profiles, lens_d=lens_d)
        else:
            t1_last, t1m1 = dense_forward(card.log_B, card.log_pi, log_obs, lengths,
                                          lens_d=lens_d)
    return _route_and_backtrace(hmm, card, t1_last, t1m1, lengths, lens_d, sp)


def _decode_fused(hmm: PreparedHMM, logits: torch.Tensor, lengths, sp, obs: dict) -> torch.Tensor:
    """K9 -> K2 on one device, the lengths uploaded once before K9; without
    a band, K5/K6 then _decode_logobs."""
    if logits.shape[-1] + 1 != hmm.S:
        raise ValueError(f"logits have {logits.shape[-1]} bins, the matrix {hmm.S} states")
    if hmm.banded is None:
        return _decode_logobs(hmm, obs_fused.log_obs(logits, obs), lengths, sp)
    with tracing.span("decode.forward"):
        card = hmm.card(logits.device)
        lengths = cuda_lib.host_lengths(lengths, *logits.shape[:2])
        lens_d = tracing.upload(lengths, logits.device, "decode")
        t1_last, t1m1 = banded_forward_obs(hmm.banded, card.log_pi, logits, lengths, obs,
                                           profiles=card.profiles, lens_d=lens_d)
    return _route_and_backtrace(hmm, card, t1_last, t1m1, lengths, lens_d, sp)


def viterbi_decode_batch_logobs(
    *, transition_matrix, prob_init, log_obs: torch.Tensor, lengths, mesh=None, hmm=None
) -> torch.Tensor:
    """Decode a [N, T, S] batch of LOG observations (unvoiced state last)
    with per-track lengths. Returns states [N, T] int32 on log_obs's
    device; entries at or beyond each track's length are unspecified. With
    `mesh`, each "data" device decodes its share of the tracks. hmm: a
    prepared HMM (hmm/prepared.py) the caller holds, taken where it holds
    the same matrix and initial probabilities."""
    with tracing.span("decode") as sp:
        hmm = _prepare(transition_matrix, prob_init, hmm)
        if mesh is not None:
            return decode_over_data(mesh, log_obs, lengths, _in_decode_span(_decode_logobs, hmm))
        return _decode_logobs(hmm, log_obs, lengths, sp)


def viterbi_decode_batch(
    *, transition_matrix, prob_init, probs_st_list, device=None, mesh=None, hmm=None
) -> list[np.ndarray]:
    """Decode a list of [S, T_i] observation-probability tracks together
    (numpy arrays or tensors). Returns [T_i] int64 state paths, bit-identical
    to the NumPy oracle given the same log observations. With `mesh`, each
    "data" device decodes its share of the tracks. hmm: as
    viterbi_decode_batch_logobs's."""
    with tracing.span("decode") as sp:
        dev = resolve_device(device)
        S = np.asarray(transition_matrix).shape[0]
        lengths = [int(p.shape[1]) for p in probs_st_list]
        with tracing.span("decode.stage"):
            obs = torch.zeros((len(lengths), max(lengths), S), dtype=torch.float32, device=dev)
            for i, p in enumerate(probs_st_list):
                obs[i, : lengths[i]] = tracing.upload(p, dev, "decode", torch.float32).T
        if sp:
            sp.set(tracks=len(lengths), frames=sum(lengths), states=S)
        states = viterbi_decode_batch_logobs(
            transition_matrix=transition_matrix, prob_init=prob_init,
            log_obs=log_obs_fn(obs), lengths=lengths, mesh=mesh, hmm=hmm,
        )
        states = tracing.to_host(states, "decode").numpy()
        return [states[i, :L].astype(np.int64) for i, L in enumerate(lengths)]


def viterbi_decode_batch_fused_obs(
    *, transition_matrix, prob_init, logits: torch.Tensor, lengths, obs: dict, mesh=None,
    hmm=None
) -> torch.Tensor:
    """Decode a [N, T, n_bins] batch of RAW logits with per-track lengths
    (counterpart of viterbi_decode_batch_pallas_fused_obs; with `mesh`, each
    "data" device runs this on its share of the tracks).
    obs: the JAX package's obs dict (hmm/obs_fused.py::obs_params). With a
    banded structure: K9, the first-max argmax, then K2 (K4 when the
    structure has no classes); without: K5/K6, then K3/K4. Returns states
    [N, T] int32 on the logits' device; entries at or beyond each track's
    length are unspecified. hmm: as viterbi_decode_batch_logobs's."""
    with tracing.span("decode") as sp:
        hmm = _prepare(transition_matrix, prob_init, hmm)
        if mesh is not None:
            return decode_over_data(mesh, logits, lengths,
                                    _in_decode_span(_decode_fused, hmm, obs=obs))
        return _decode_fused(hmm, logits, lengths, sp, obs)
