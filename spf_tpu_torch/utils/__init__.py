"""Host-side utilities of the port: numpy encryption of program inputs and
outputs (`host_crypto`), counters and profiling (`profiling`), the
lattice-estimator fits (`security`), key and ciphertext (de)serialization
(`serialization`), combinadics (`combinatorics`) and empirical noise
measurement (`noise`)."""
