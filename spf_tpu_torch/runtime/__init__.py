"""The runtime of the port: the FheCircuit graph (`fhe_circuit`), its
fluent integer builder (`fluent`), and the two executors that run it on
the port's ops, one batched wave per level (`executor_u32`) and from slot
buffers (`wave_machine`)."""
