"""The benchmark of viterbi_spl_tpu_torch: run.py runs one cell of BENCHMARK.json."""
