"""The benchmark of `spf_tpu_torch`, the PyTorch and CUDA port: one cell a
run, `python3 -m tfhe_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (see `run.py`)."""
