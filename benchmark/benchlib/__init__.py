"""The benchmark harness of cdlnet_tpu_torch (benchmark/run.py drives it)."""
