"""The benchmark harness of fib_tf_tpu_torch (see run.py)."""
