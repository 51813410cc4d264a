"""Torus, ds32 and bootstrap operations of the port; each module mirrors
the `spf_tpu/ops` module of the same role (`ntt`: the Goldilocks NTT on
the host; `u64/`: the u64 API's family)."""
