"""The benchmark of the PyTorch port (``neuralsvb_torch``) on one NVIDIA
H100: ``python3 -m svb_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``svb_bench/README.md``."""
