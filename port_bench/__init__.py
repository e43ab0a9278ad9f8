"""The PyTorch and CUDA port's benchmark: one command runs one cell once,
`python3 -m port_bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`."""
