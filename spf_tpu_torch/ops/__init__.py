"""Torus, ds32 and bootstrap operations of the port; each module mirrors
the `spf_tpu/ops` module of the same role."""
