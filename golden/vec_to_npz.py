"""Convert golden_driver text vectors into the compressed npz consumed by
tests/ (same layout as tests/golden_sym_4096_3.npz)."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from seal_embedded_jax.io.serialize import parse_poly_stream  # noqa: E402


def convert(path, n, nprimes, out):
    polys = parse_poly_stream(open(path))
    data = {}
    sk = [v for name, v in polys if name == "sk_packed"]
    data["sk_packed_0"] = np.array(sk[0], dtype=np.uint8)
    t = -1
    ct = 0
    pk = 0
    for name, vals in polys:
        if name == "v":
            t += 1
            data[f"v_{t}"] = np.array(vals, dtype=np.float32)
        elif name == "pt":
            data[f"pt_{t}"] = np.array(vals, dtype=np.int64)
        elif name == "pte":
            data[f"pte_{t}"] = np.array(vals, dtype=np.int64)
        elif name == "pk_ep":
            data["pk_ep"] = np.array(vals, dtype=np.int8)
        elif name == "u_packed":
            assert t >= 0, "u_packed line before first 'v' line"
            data[f"u_packed_{t}"] = np.array(vals, dtype=np.uint8)
        elif name == "e1":
            assert t >= 0, "e1 line before first 'v' line"
            data[f"e1_{t}"] = np.array(vals, dtype=np.int8)
        elif name.startswith("pk0"):
            data[f"pk0_{pk}"] = np.array(vals, dtype=np.uint32)
        elif name.startswith("pk1"):
            data[f"pk1_{pk}"] = np.array(vals, dtype=np.uint32)
            pk += 1
        elif name.startswith("c0"):
            data[f"c0_{ct}"] = np.array(vals, dtype=np.uint32)
        elif name.startswith("c1"):
            data[f"c1_{ct}"] = np.array(vals, dtype=np.uint32)
            ct += 1
    assert ct == (t + 1) * nprimes, (ct, t, nprimes)
    assert pk in (0, nprimes), (pk, nprimes)
    np.savez_compressed(out, **data)
    print(f"{out}: {t + 1} tests, {nprimes} primes, n={n}, pk_limbs={pk}")


if __name__ == "__main__":
    convert(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
