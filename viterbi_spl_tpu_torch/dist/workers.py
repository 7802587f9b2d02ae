"""The multi-process runtime's checks: two OS processes joined by
utils.initialize_distributed (gloo over a localhost port), each owning two
entries of a process-spanning mesh (two CPU blocks, or cuda:0 twice), run
the JAX package's multi-process workers (tests/test_multiprocess.py) on
the port:

- decode: a global all-reduce equal to the sum, then
  decode_tracks_sharded over a data-sharded global batch, each process
  holding the tracks it decoded (K3/K4 on a card) to the NumPy oracle;
- tp: tensor-parallel training of a two-layer MLP on a data=2,model=2 mesh
  across the processes against a one-process replicated run (losses at
  rtol 1e-4, the updated parameters within the Adam bound rtol 1e-3, atol
  2 lr), with the barriered checkpoint of the sharded state and a resume
  into a fresh sharded template in between;
- ckpt: two epochs of a replicated toy step over a data=4 mesh with a
  checkpoint each epoch (process 0 writes between barriers), then every
  process restores the same state;
- bn: two of msnet's train steps on a data=2 mesh across the processes
  (BatchNorm's statistic sums and their gradients reduced across
  processes) against the single-device steps on the same batches: losses
  at rtol 1e-4, the BatchNorm averages after step 1 within 1e-4 (a mean's
  difference over its channel's standard deviation, a variance's over
  itself), the params within the Adam bound (rtol 1e-3, atol 2 lr a step).

    python -m viterbi_spl_tpu_torch.dist.workers CHECKS PROCESS_ID NUM PORT DEVICE DIR

CHECKS: one check, or several separated by commas, run in turn in the
same two processes. Each process prints `WORKER_RESULT <json>` (each
check's numbers, and the kernel launches it made) and `WORKER_OK <checks>
<process id>`, and exits non-zero
when a check fails. `spawn` starts the processes and collects their output
(tests/test_torch_multiprocess.py on the CPU, chip_smoke.py on the card).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CHECKS = ("decode", "tp", "ckpt", "bn")
TP_LR = 1e-3


def _check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _launches() -> dict:
    from ..hmm.viterbi_dense import KERNEL_WRAPPERS

    return {k: w.launches for k, w in KERNEL_WRAPPERS.items() if w.launches}


def check_decode(device: str, workdir: Path) -> dict:
    from ..dist import decode_tracks_sharded
    from ..dist.mesh import local_tracks, make_mesh, process_devices
    from ..dist.train import world_all_reduce
    from ..hmm.oracle import viterbi_oracle
    from ..hmm.viterbi import TINY, prepare_log_params
    from ..utils import process_count

    devices = process_devices([device, device])
    _check(len(devices) == 2 * process_count(), f"{len(devices)} mesh devices")
    mesh = make_mesh(data=len(devices), devices=devices)
    N = len(devices)
    mine = local_tracks(mesh, N)

    # 1. the global all-reduce across the process boundary
    full = np.arange(N * 4, dtype=np.float32).reshape(N, 4)
    total = torch.from_numpy(full[mine]).to(device).sum().reshape(1)
    world_all_reduce([total])
    _check(float(total) == float(full.sum()), f"all-reduce {float(total)} != {full.sum()}")

    # 2. track-parallel decode, the tracks sharded across processes
    rng = np.random.default_rng(0)  # the same seed everywhere: shared global data
    S, T = 33, 64
    A = rng.random((S, S)).astype(np.float64) ** 2 + np.eye(S) * 3
    A /= A.sum(1, keepdims=True)
    pi = rng.random(S)
    pi /= pi.sum()
    obs = rng.random((N, T, S)).astype(np.float32) ** 2
    obs /= obs.sum(-1, keepdims=True)
    log_B, log_pi = prepare_log_params(A, pi)
    log_obs = np.log(obs + TINY).astype(np.float32)
    states = decode_tracks_sharded(log_B, log_pi, torch.from_numpy(log_obs).to(device), mesh)
    launches = _launches()
    got = states.cpu().numpy()
    _check(got.shape == (mine.stop - mine.start, T), f"local states {got.shape}")
    for k, i in enumerate(range(mine.start, mine.stop)):
        want = viterbi_oracle(transition_matrix=A.astype(np.float32), prob_init=pi,
                              probs_st=obs[i].T)
        _check(np.array_equal(want, got[k]), f"track {i} differs from the oracle")
    return {"tracks": [mine.start, mine.stop], "all_reduce": float(total), "launches": launches}


class _MLP(torch.nn.Module):
    """tanh(x W1 + b1) W2 + b2, W drawn as the JAX worker draws its kernels."""

    def __init__(self):
        from ..models.layers import Dense

        super().__init__()
        self.dense1, self.dense2 = Dense(8, 16), Dense(16, 4)
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for layer, shape in ((self.dense1, (8, 16)), (self.dense2, (16, 4))):
                layer.weight.copy_(torch.from_numpy(rng.normal(size=shape) * 0.3).T)
                layer.bias.zero_()

    def forward(self, x):
        return self.dense2(torch.tanh(self.dense1(x)))


def _mlp_batch(step: int, device):
    w_true = np.random.default_rng(7).normal(size=(8, 4)).astype(np.float32)
    x = np.random.default_rng(100 + step).normal(size=(8, 8)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(x @ w_true).to(device)


def _mlp_step(params, batch_stats, opt_state, batch, step):
    """The mesh train step of the MLP: each share's squared error, the
    global mean, one update."""
    opt_state.zero_grad()
    losses = opt_state.run(lambda i, model, item: torch.mean(
        (model(item[0].to(opt_state.devices[i])) - item[1].to(opt_state.devices[i])) ** 2),
        opt_state.local_shares(*batch))
    loss = opt_state.share_mean(losses)
    loss.backward()
    opt_state.step()
    return params, batch_stats, opt_state, opt_state.world_sum(loss.detach())


def check_tp(device: str, workdir: Path) -> dict:
    from ..dist.mesh import process_devices
    from ..dist.tp import make_tp_mesh
    from ..dist.train import MeshOptimizer
    from ..harness.train import Trainer, TrainState

    # the replicated single-device reference (same data)
    ref = _MLP().to(device)
    ref_opt = torch.optim.Adam(ref.parameters(), lr=TP_LR)
    ref_losses = []
    for k in range(3):
        x, y = _mlp_batch(k, device)
        ref_opt.zero_grad()
        loss = torch.mean((ref(x) - y) ** 2)
        loss.backward()
        ref_opt.step()
        ref_losses.append(float(loss))

    # data=2 x model=2 across the processes: channel-sharded params and moments
    mesh = make_tp_mesh(2, 2, devices=process_devices([device, device]))

    def fresh():
        model = _MLP()
        opt = MeshOptimizer(model, mesh, lambda ps: torch.optim.Adam(ps, lr=TP_LR))
        return model, opt

    model, opt = fresh()
    sharded = sorted(n for n, sh in opt.store.items() if sh.spec is not None)
    _check("dense1.weight" in sharded, f"sharded leaves {sharded}")
    params = dict(model.named_parameters())
    tp_losses = []
    for k in range(2):
        *_, loss = _mlp_step(params, {}, opt, _mlp_batch(k, device), k)
        tp_losses.append(float(loss))
    # the Adam moments follow their param's split
    shard = opt.store["dense1.weight"].shards[0]
    _check(opt.optimizer.state[shard]["exp_avg"].shape == shard.shape == (8, 8),
           "dense1's Adam moments lie split as its kernel")

    # the barriered checkpoint of the sharded state, then a resume into a
    # fresh sharded template
    trainer = Trainer(_mlp_step, lambda s: dict(oa=0.5, voicing_threshold=0.5),
                      ckpt_path=workdir / "tp_ckpt.pt")
    trainer.save(TrainState(params=params, batch_stats={}, opt_state=opt, step=2))
    model2, opt2 = fresh()
    restored = trainer.restore(TrainState(params=dict(model2.named_parameters()),
                                          batch_stats={}, opt_state=opt2))
    _check(restored.step == 2, f"restored step {restored.step}")
    _check(opt2.store["dense1.weight"].spec is not None, "the restored kernel is sharded")
    for name, t in restored.params.items():
        _check(torch.equal(t, params[name]), f"restored {name}")
    *_, loss = _mlp_step(restored.params, {}, opt2, _mlp_batch(2, device), 2)
    tp_losses.append(float(loss))

    np.testing.assert_allclose(tp_losses, ref_losses, rtol=1e-4)
    # the updated params: ulp-level gradient differences near zero become
    # +-lr sign flips in Adam, so atol ~ 2 lr (the JAX worker's bound)
    err = 0.0
    for name, want in ref.named_parameters():
        got = restored.params[name].detach().cpu().numpy()
        want = want.detach().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=2 * TP_LR, err_msg=name)
        err = max(err, float(np.abs(got - want).max()))
    return {"tp_losses": tp_losses, "ref_losses": ref_losses, "sharded": sharded,
            "max_param_err": err}


def check_ckpt(device: str, workdir: Path) -> dict:
    from ..dist.mesh import make_mesh, process_devices
    from ..dist.train import world_all_reduce
    from ..harness.train import Trainer, TrainState

    devices = process_devices([device, device])
    mesh = make_mesh(data=len(devices), devices=devices)
    N = len(devices)
    rows = mesh.local_rows()

    def train_step(params, batch_stats, opt_state, batch, step):
        # the mean of the data-sharded batch: local shares, then every process
        mean = sum(batch[r].to(mesh.devices[r][0]).sum() for r in rows).reshape(1)
        world_all_reduce([mean])
        with torch.no_grad():
            grad = mean / batch.numel() * params["w"]
            params["w"] -= 0.01 * grad
        total = grad.sum().reshape(1)
        return params, batch_stats, opt_state, total

    def batches():
        k = 0
        while True:
            yield torch.full((N, 8), 1.0 + k)
            k += 1

    oas = iter([0.5, 0.6])  # improves every epoch -> a save every epoch

    def validate(state):
        return dict(oa=next(oas), voicing_threshold=0.4)

    def template():
        return TrainState(params={"w": torch.ones(4, device=device)},
                          batch_stats={"m": torch.zeros(2, device=device)})

    trainer = Trainer(train_step, validate, ckpt_path=workdir / "shared_ckpt.pt",
                      patience_epochs=10, max_epochs=2)
    state = trainer.fit(template(), batches(), steps_per_epoch=3)
    _check(state.best_oa == 0.6, f"best oa {state.best_oa}")
    # resume across the process boundary: every process restores the same state
    restored = trainer.restore(template())
    _check(abs(restored.voicing_threshold - 0.4) < 1e-6, "restored threshold")
    _check(abs(restored.best_oa - 0.6) < 1e-6, "restored best oa")
    _check(restored.step == 6, f"restored step {restored.step}")
    _check(torch.equal(restored.params["w"], state.params["w"]), "restored params")
    return {"w": restored.params["w"].cpu().tolist(), "step": restored.step}


def check_bn(device: str, workdir: Path) -> dict:
    import dataclasses

    from ..apps import common as AC
    from ..apps import msnet
    from ..dist.mesh import make_mesh, process_devices
    from ..dist.train import MeshOptimizer

    cfg = dataclasses.replace(msnet.config(), batch_size=4, snippet_len=50)
    train = AC.synthetic_dataset(cfg, 2, 400, 0)
    stream = AC.training_batches(cfg, train, np.random.default_rng(0), "cpu", full_batches=True)
    batches = [next(stream) for _ in range(2)]

    def run(step, params, stats, opt):
        losses, after_first = [], None
        for s, b in enumerate(batches):
            losses.append(float(step(params, stats, opt, b, s, 0.5)[3]))
            if s == 0:
                after_first = {k: t.detach().to("cpu", torch.float64) for k, t in stats.items()}
        return losses, after_first

    model, params, stats = AC.init_model(cfg, seed=0, device=device)
    want, want_bn = run(AC.make_train_step(cfg, model), params, stats,
                        AC.make_optimizer(cfg, model, 8))
    mesh = make_mesh(data=2, devices=process_devices([device]))
    m_model, m_params, m_stats = AC.init_model(cfg, seed=0, device=device)
    m_opt = MeshOptimizer(m_model, mesh, lambda ps: AC.make_optimizer(cfg, None, 8, params=ps))
    got, got_bn = run(AC.make_mesh_train_step(cfg, m_opt), m_params, m_stats, m_opt)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the averages after step 1 (the same params on both sides: only sum
    # orders differ): a running mean's difference over its channel's
    # standard deviation, a running variance's over itself
    bn_err = 0.0
    for k, w in want_bn.items():
        scale = want_bn[k[: -len("mean")] + "var"].sqrt() if k.endswith(".mean") else w
        bn_err = max(bn_err, float(((got_bn[k] - w).abs() / scale).max()))
    _check(bn_err < 1e-4, f"BatchNorm averages after step 1 {bn_err} apart")
    # the Adam bound a step: an element whose gradient is near 0 may take
    # the other sign in one run, and each run moves it by at most lr (Adam's
    # |m / sqrt(v)| <= 1.0013 over two steps), so 2 lr a step taken
    for name, t in params.items():
        np.testing.assert_allclose(m_params[name].detach().cpu().numpy(),
                                   t.detach().cpu().numpy(), rtol=1e-3,
                                   atol=2 * cfg.learning_rate * len(batches), err_msg=name)
    return {"losses": got, "single_losses": want, "bn_err_after_step_1": bn_err}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    check, process_id, num, port, device, workdir = argv
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    from ..utils import initialize_distributed, process_count

    initialize_distributed("127.0.0.1:" + port, int(num), int(process_id))
    _check(process_count() == int(num), f"{process_count()} processes")
    result = {name: globals()[f"check_{name}"](device, Path(workdir))
              for name in check.split(",")}
    print("WORKER_RESULT " + json.dumps(result), flush=True)
    print(f"WORKER_OK {check} {process_id}", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(check: str, device: str, workdir, n: int = 2, timeout: float = 540.0):
    """Run `check` in n processes -> (exit codes, outputs, results): each
    process's WORKER_RESULT, None where it printed none. A run that
    outlasts `timeout` seconds is killed, every process with it."""
    if not set(check.split(",")) <= set(CHECKS):
        raise ValueError(f"unknown check {check!r}; have {CHECKS}")
    Path(workdir).mkdir(parents=True, exist_ok=True)
    port = free_port()
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in env.get("PYTHONPATH", "").split(
        os.pathsep) if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "viterbi_spl_tpu_torch.dist.workers", check, str(i), str(n),
         str(port), device, str(workdir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("WORKER_RESULT ")]
        results.append(json.loads(lines[-1][len("WORKER_RESULT "):]) if lines else None)
    return [p.returncode for p in procs], outs, results


if __name__ == "__main__":
    sys.exit(main())
