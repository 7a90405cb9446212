"""The command-line interface (PyTorch port of urh_tpu.cli)."""
