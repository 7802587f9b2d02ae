"""Per-family applications (counterpart of viterbi_spl_tpu/apps/): each
wires Config -> data -> model -> Trainer/eval through the shared harness,
on CUDA unless --device cpu. Run e.g.:

    python -m viterbi_spl_tpu_torch.apps.msnet train --synthetic --debug --ckpt ck.pt
    python -m viterbi_spl_tpu_torch.apps.msnet infer --synthetic --debug --ckpt ck.pt
    python -m viterbi_spl_tpu_torch.apps.imm eval --synthetic

`--synthetic` builds a tiny synthetic dataset (no dataset roots needed);
without it the apps read the env-var dataset roots (medleydb,
melody2_dir, ...)."""
