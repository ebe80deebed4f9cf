"""tidb_tpu_torch — the PyTorch/CUDA port of tidb_tpu.

The same layers as tidb_tpu (session -> parser -> planner -> executor ->
coprocessor fragments over a device-resident columnar store), with the
device path written in PyTorch and its hot loops in hand-written CUDA
kernels for Hopper (ops/csrc/). The host layers are copies of the
reference's, with imports pointed at this package; nothing here imports
jax or tidb_tpu.

Every entry point runs on the CUDA device unless the caller asks for
the CPU (`new_store(device="cpu")`, `TestKit(device="cpu")`, `--cpu`).
The MySQL wire server (`--serve`) answers from the card. Surfaces not
ported yet (vector search, in-SQL inference, the replica fabric, MPP,
BR) fail with a "not yet ported" error.
"""

__version__ = "0.1.0"
