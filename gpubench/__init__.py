"""The benchmark of gamma_tpu_torch on NVIDIA GPUs.

`python gpubench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root's BENCHMARK.json and prints one
JSON line.  Everything a cell needs is found by name: its configuration
in configs/, its traffic mix in traffic/, its limits in limits/ and each
metric's reader in metrics/.  Nothing here imports jax or gamma_tpu, and
reference/ imports nothing of gamma_tpu_torch.
"""
