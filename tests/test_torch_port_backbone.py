"""CSPDarknet + YOLOPAFPN of the port against the JAX package on the CPU.

JAX initialises the module (BN statistics and affine parameters then
drawn at random so the folding and the 1e-5 BN eps matter),
`state_dict_from_flax` carries the weights into the port, and both run
the same seeded image. Tolerance: fp32 convs with another summation
order, 1e-4 relative on features of unit scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tscd_tpu.models.darknet import CSPDarknet as JDarknet
from tscd_tpu.models.pafpn import YOLOPAFPN as JPAFPN
from tscd_tpu.utils.convert import torch_to_flax
from tscd_torch.models.darknet import CSPDarknet
from tscd_torch.models.pafpn import YOLOPAFPN
from tscd_torch.models.pafpn_variants import YOLOPAFPN_Swin, build_pafpn_backbone
from torch_port_util import carry


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the tests run beside others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_darknet_features_match():
    x = np.random.default_rng(1).uniform(0, 255, (2, 64, 96, 3)).astype(np.float32)
    jm = JDarknet(0.33, 0.125)
    pm = CSPDarknet(0.33, 0.125).eval()
    variables = carry(jm, pm, jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert set(got) == set(want) == {"dark3", "dark4", "dark5"}
    for k in want:
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), atol=1e-4, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("width,h,w", [(0.125, 64, 64), (0.25, 96, 64)])
def test_pafpn_outputs_match(width, h, w):
    x = np.random.default_rng(2).uniform(0, 255, (2, h, w, 3)).astype(np.float32)
    jm = JPAFPN(0.33, width)
    pm = YOLOPAFPN(0.33, width).eval()
    variables = carry(jm, pm, jnp.asarray(x))
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for g, wnt in zip(got, want):
        assert g.shape[2:] == wnt.shape[1:3]
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(wnt),
                                   atol=1e-4, rtol=1e-4)
    # the port's names map back onto exactly the JAX tree
    conv = torch_to_flax({k: v.numpy() for k, v in pm.state_dict().items()})
    for coll in ("params", "batch_stats"):
        a = {k: v.shape for k, v in traverse_util.flatten_dict(conv[coll]).items()}
        b = {k: v.shape for k, v in traverse_util.flatten_dict(variables[coll]).items()}
        assert a == b


def test_uint8_frames_cast_exactly():
    x = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3)).astype(np.uint8)
    pm = YOLOPAFPN(0.33, 0.125).eval()
    with torch.no_grad():
        a = pm(torch.from_numpy(x))
        b = pm(torch.from_numpy(x.astype(np.float32)))
    for u, f in zip(a, b):
        assert torch.equal(u, f)


def test_other_backbones_raise_until_ported():
    """Every name JAX maps builds its pyramid (Swin_Tiny here); a name JAX
    does not know raises ValueError, as JAX's."""
    assert isinstance(build_pafpn_backbone("Swin_Tiny", 0.33, 0.125), YOLOPAFPN_Swin)
    with pytest.raises(ValueError):
        build_pafpn_backbone("ViT", 0.33, 0.125)
