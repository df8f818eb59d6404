"""The benchmark of world_tpu_torch on one H100: ``python portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` (see run.py)."""
