"""The port's counterparts of the measurement harnesses under the root exp/
whose Pallas kernels it replaces: dfn5b_attention (X2), attn_v2 (X1) and
int8_matmul_probe (X3). Nothing runs at import; each file's functions take
device= (CUDA by default; the tests pass "cpu", where the kernels' plain
versions run)."""
