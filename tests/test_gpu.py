"""Golden checks on the card: `python -m pytest tests/test_gpu.py -m gpu`.

The same checks as chip_smoke.py phases b-d, one test each, at the widths
the pipelines use.  Without a GPU every test here skips.
"""

import pathlib
import sys

import jax
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The first device, if it is a GPU; decided when the test runs."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX found {dev.platform}); "
                    "run with -m gpu on a machine with one")
    return dev


def test_keccak_kernel_real_widths(gpu):
    import chip_smoke
    chip_smoke.kernel_check()


@pytest.mark.parametrize("kind,n,L", [("sym", 4096, 3), ("sym", 16384, 13),
                                      ("asym", 16384, 13)])
def test_golden_pipeline_api(kind, n, L, gpu):
    """One B=1024 batch through api.se_encrypt_seeded: golden rows bit for
    bit, ok flags, canonical coefficients."""
    import chip_smoke
    from seal_embedded_jax import api
    from seal_embedded_jax.config import default_parms

    gold = chip_smoke.load_golden(kind, n, L)
    parms = default_parms(n, L)
    key = {"sk": gold["sk"]} if kind == "sym" else {"pk": gold["pk"]}
    ctx = api.se_setup_custom(n, L, parms.scale,
                              api.SYM if kind == "sym" else api.ASYM, **key)
    values, share, err = chip_smoke.batch_inputs(
        gold, n, chip_smoke.B, np.random.default_rng(0))
    out = api.se_encrypt_seeded(ctx, values,
                                share_seeds=share if kind == "sym" else None,
                                seeds=err)
    chip_smoke.check_batch(out, gold, parms)


def test_encode_bits(gpu):
    """The platform's automatic encode mode is bit-exact on every golden
    shape, and dd stays decode-exact."""
    import chip_smoke
    chip_smoke.encode_bits()
