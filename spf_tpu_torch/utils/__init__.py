"""Host-side utilities of the port: numpy encryption of program inputs and
outputs (`host_crypto`) and counters and profiling (`profiling`)."""
