"""The runtime of the port: the u64 API (`keys`, `encryption`,
`evaluation`, and `executor`'s batched `CircuitExecutor`), the FheCircuit
graph (`fhe_circuit`), its fluent integer builder (`fluent`), and the two
executors over the port's kernels, one batched wave per level
(`executor_u32`) and from slot buffers (`wave_machine`)."""

from .keys import ComputeKey, PublicKey, SecretKey, generate_keys  # noqa: F401
from .encryption import Encryption  # noqa: F401
from .evaluation import Evaluation  # noqa: F401
