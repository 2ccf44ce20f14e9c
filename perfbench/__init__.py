"""The benchmark of the PyTorch and CUDA port (``babe_tpu_torch``): its
harness, traffic, reference, counts and metric readers.  Run it as
``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository's root."""
