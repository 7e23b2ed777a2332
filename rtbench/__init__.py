"""The benchmark of the PyTorch and CUDA port ``tpu_raytracer_torch``:
``python -m rtbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` (``run.py``). See ``README.md``."""
