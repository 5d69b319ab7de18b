"""LSM backward induction, the fused path kernels with their plain
versions, and the streaming engine."""
