"""Validate the Python golden model bit-exactly against the C reference driver output."""
import os, sys, numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from seal_embedded_jax.config import default_parms
from seal_embedded_jax.golden import ckks
from seal_embedded_jax.golden.prng import Prng
from seal_embedded_jax.golden.sampling import sample_small_poly_ternary_96
from seal_embedded_jax.io.serialize import parse_poly_stream

def seed(tag): return bytes((tag + i) & 0xFF for i in range(64))

def set_values(testnum, vlen):
    v = np.zeros(vlen, dtype=np.float32)
    i = np.arange(vlen)
    if testnum == 0: pass
    elif testnum == 1: v[:] = 1
    elif testnum == 2: v[:] = (i % 2).astype(np.float32)
    elif testnum == 3: v[:] = (i / float(vlen)).astype(np.float32)
    elif testnum == 4: v[:] = (((i % 7) - 3) * 0.5).astype(np.float32)
    else: v[:] = ((((i * 2654435761) >> 16) & 0xFF) * 0.01 - 1.0).astype(np.float32)
    return v

path = sys.argv[1] if len(sys.argv) > 1 else 'vec_sym_4096_3.txt'
n = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
nprimes = int(sys.argv[3]) if len(sys.argv) > 3 else 3
polys = parse_poly_stream(open(path))
p = default_parms(n, nprimes)

# sk
skp = dict_first = [v for name, v in polys if name == 'sk_packed'][0]
sk_golden = sample_small_poly_ternary_96(n, Prng(seed(1)))
assert bytes(skp) == sk_golden, 'sk mismatch'
print('sk ok')

tests = []
cur = None
for name, vals in polys:
    if name == 'v':
        cur = {'v': vals, 'c0': [], 'c1': []}
        tests.append(cur)
    elif name in ('pt', 'pte'):
        cur[name] = vals
    elif name in ('c0', 'c1'):
        cur[name].append(vals)

for tn, t in enumerate(tests):
    share_prng = Prng(seed(2))  # ckks_sym_init resets it every encode-encrypt sequence
    v = set_values(tn, n // 2)
    # encode check
    from seal_embedded_jax.golden.encode import encode_base
    pt = encode_base(p, v)
    assert np.array_equal(pt, np.array(t['pt'], dtype=np.int64)), f'test {tn}: pt mismatch'
    # pte: error prng reset each test with err_seed
    from seal_embedded_jax.golden.sampling import sample_add_poly_cbd_16
    pte = np.array(sample_add_poly_cbd_16(pt.tolist(), Prng(seed(3))), dtype=np.int64)
    assert np.array_equal(pte, np.array(t['pte'], dtype=np.int64)), f'test {tn}: pte mismatch'
    # per-prime c0/c1; note shareable_prng persists across tests/primes in driver
    from seal_embedded_jax.golden.sampling import sample_poly_uniform, expand_poly_ternary
    from seal_embedded_jax.golden.ntt import ntt_inpl
    for i, q in enumerate(p.moduli):
        w = p.ntt_root(q)
        c1 = sample_poly_uniform(n, q, share_prng)
        assert c1 == t['c1'][i], f'test {tn} prime {i}: c1 mismatch'
        s = expand_poly_ternary(sk_golden, n, q)
        ntt_s = ntt_inpl(s, n, p.logn, q, w)
        c0 = [(q - (x * y) % q) % q for x, y in zip(ntt_s, c1)]
        ntt_pte = ntt_inpl(ckks.reduce_pte(pte, q), n, p.logn, q, w)
        c0 = [(x + y) % q for x, y in zip(c0, ntt_pte)]
        if c0 != t['c0'][i]:
            bad = [j for j in range(n) if c0[j] != t['c0'][i][j]][:5]
            print(f'test {tn} prime {i}: c0 mismatch at {bad}; got {[c0[j] for j in bad]} want {[t["c0"][i][j] for j in bad]}')
            sys.exit(1)
    print(f'test {tn} ok (pt, pte, {nprimes} x c0/c1 bit-exact)')
print('ALL GOLDEN SYM VECTORS BIT-EXACT')
