"""Pure-Python/NumPy golden model: the bit-exactness oracle for every
JAX op and kernel, validated against the C reference binary (see tests/ and
golden/README.md)."""
