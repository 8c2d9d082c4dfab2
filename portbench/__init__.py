"""The benchmark of clstm_tpu_torch, the PyTorch and CUDA port, on an
NVIDIA H100: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (harness.py)."""
