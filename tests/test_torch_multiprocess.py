"""The port's multi-process runtime across a real process boundary (the
port of tests/test_multiprocess.py): two OS processes joined by
utils.initialize_distributed (gloo over a localhost port), two CPU blocks
each, run the workers of viterbi_spl_tpu_torch/dist/workers.py:

1. decode: a global all-reduce equal to the sum, and decode_tracks_sharded
   over a data-sharded global batch, each process holding the tracks it
   decoded to the NumPy oracle;
2. tp: tensor-parallel training (dist/tp.py) on a data=2,model=2 mesh
   spanning the processes, the barriered checkpoint of the sharded state,
   a resume into a fresh sharded template, then the losses (rtol 1e-4) and
   the updated params (the Adam bound rtol 1e-3, atol 2 lr) against the
   one-process replicated run;
3. ckpt: two epochs with a checkpoint each epoch (process 0 writes between
   barriers), then both processes restore the same state;
4. bn: msnet's mesh train step with one data share a process, so that
   BatchNorm's statistics and their gradients are reduced across the
   processes, against the single-device step (losses at rtol 1e-4, the
   BatchNorm averages after step 1 within 1e-4, the params within the
   Adam bound, 2 lr a step taken).

The four run in turn in one pair of processes (a module fixture), each
test reading its check's results; the workers hold the asserts and exit
non-zero on a failed one. Skips only where the platform forbids the
localhost socket, as the JAX file does. The workers run PyTorch on one
thread.
"""

import pytest

from torch_threads import one_thread  # noqa: F401 (fixture)
from viterbi_spl_tpu_torch.dist.workers import CHECKS, spawn


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every check, in turn, in one pair of processes (as chip_smoke.py
    runs them on the card) -> {check: [process 0's result, process 1's]}."""
    checks = ",".join(CHECKS)
    codes, outs, res = spawn(checks, "cpu", tmp_path_factory.mktemp("mp"), timeout=540)
    joined = "\n---\n".join(outs)
    if any(c != 0 for c in codes) and (
        "Permission" in joined or "failed to connect" in joined.lower()
        or "Address family not supported" in joined
    ):
        pytest.skip("platform forbids the localhost rendezvous:\n" + joined)
    assert codes == [0, 0], joined
    assert f"WORKER_OK {checks} 0" in joined and f"WORKER_OK {checks} 1" in joined, joined
    return {check: [r[check] for r in res] for check in CHECKS}


def test_two_process_distributed_decode(results):
    # each process decoded its own half of the 4 tracks
    assert [r["tracks"] for r in results["decode"]] == [[0, 2], [2, 4]]
    assert all(r["all_reduce"] == 120.0 for r in results["decode"])


def test_two_process_tensor_parallel_training(results):
    tp = results["tp"]
    assert tp[0]["tp_losses"] == tp[1]["tp_losses"]
    assert tp[0]["sharded"] == ["dense1.bias", "dense1.weight", "dense2.bias", "dense2.weight"]


def test_two_process_checkpoint_and_resume(results):
    ckpt = results["ckpt"]
    assert ckpt[0] == ckpt[1] and ckpt[0]["step"] == 6


def test_two_process_batchnorm_across_processes(results):
    bn = results["bn"]
    assert bn[0]["losses"] == bn[1]["losses"]
    assert bn[0]["bn_err_after_step_1"] < 1e-4
