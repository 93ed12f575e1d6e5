"""The port's ``models/kvcache.py`` against the JAX package's.

On a reduced qwen3-0.6b decode cache -- the reference's weights across
through ``models/convert.py``, the port's step decode filling the bf16
cache, the reference given the same values -- both packages'
``compress_cache`` / ``decompress_cache``, ``offload_prefix``,
``page_in_blocks`` and ``page_in_blocks_batched`` give the same ratios,
block archives, stats and bf16 values.  The port pages in place, so its
caller's tensors are the ones updated.

The port runs on the CPU by request (``backend="ref"``).  Every comparison
is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro.core import Codec as JCodec, CodecConfig as JCodecConfig
from repro.core.cache import PlanCache as JPlanCache
from repro.models import kvcache as jkv
from repro.models import transformer as JT
from repro.store import KVPager as JKVPager

from repro_torch import configs as PCFG
from repro_torch.core.cache import PlanCache
from repro_torch.core.codec import Codec, CodecConfig
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import kvcache
from repro_torch.models import steps as S
from repro_torch.store import KVPager, PageLostError

from test_torch_stream import as_bytes

STEPS = 32


def _codec():
    return Codec(CodecConfig(backend="ref"), plan_cache=PlanCache())


def _jcodec():
    return JCodec(JCodecConfig(), plan_cache=JPlanCache())


@pytest.fixture(scope="module")
def caches():
    """The port's bf16 cache after ``STEPS`` decode steps of a reduced
    qwen3-0.6b with the reference's weights, and the same values as JAX
    arrays."""
    jcfg = JCFG.get_config("qwen3-0.6b").reduced()
    pcfg = PCFG.get_config("qwen3-0.6b").reduced()
    tree = jax.tree.map(np.asarray, JT.init_model(jax.random.PRNGKey(1),
                                                  jcfg))
    params = convert.params_from_jax(tree, pcfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, pcfg.vocab, (2, STEPS)))
    cache = D.init_cache(pcfg, 2, STEPS, "cpu")
    serve = S.make_serve_step(pcfg)
    for t in range(STEPS):
        _, cache = serve(params, toks[:, t:t + 1], cache, t)
    assert cache["k"].dtype == torch.bfloat16 and cache["k"].any()
    return cache


def _pair(cache):
    """A fresh copy of the cache for each package."""
    port = {k: v.clone() for k, v in cache.items()}
    jax_ = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
            for k, v in cache.items()}
    return port, jax_


def _same(port, jax_):
    assert set(port) == set(jax_)
    for k in jax_:
        assert str(port[k].dtype).removeprefix("torch.") == \
            np.asarray(jax_[k]).dtype.name, k
        assert as_bytes(port[k]) == np.asarray(jax_[k]).tobytes(), k


def test_compress_cache_against_the_reference(caches):
    port, jax_ = _pair(caches)
    cc = kvcache.compress_cache(port, codec=_codec(), skip=("v",))
    jcc = jkv.compress_cache(jax_, codec=_jcodec(), skip=("v",))
    assert list(cc.blobs) == ["k"] and sorted(jcc.blobs) == ["k"]
    assert cc.orig_dtypes == jcc.orig_dtypes == {"k": "bfloat16"}
    assert cc.orig_shapes == {"k": tuple(jcc.orig_shapes["k"])}
    # 2 B a value whatever the dtype, as the reference counts
    assert cc.original_bytes == jcc.original_bytes == \
        2 * caches["k"].numel()
    assert cc.compressed_bytes == jcc.compressed_bytes
    assert cc.ratio == jcc.ratio
    got = kvcache.decompress_cache(cc, codec=_codec())
    want = jkv.decompress_cache(jcc, codec=_jcodec())
    _same(got, want)
    # the input cache is not written
    assert torch.equal(port["k"], caches["k"])


def test_offload_and_page_in_against_the_reference(tmp_path, caches):
    port, jax_ = _pair(caches)
    pager = KVPager(str(tmp_path / "port"), codec=_codec())
    jpager = JKVPager(str(tmp_path / "jax"), codec=_jcodec())
    out, ids = kvcache.offload_prefix(port, pager, 24, block_tokens=8)
    jax_, jids = jkv.offload_prefix(jax_, jpager, 24, block_tokens=8)
    assert out is port and ids == jids == [0, 1, 2]
    assert not port["k"][:, :, :24].any()
    assert torch.equal(port["k"][:, :, 24:], caches["k"][:, :, 24:])
    _same(port, jax_)
    assert pager.stats == jpager.stats and pager.ratio == jpager.ratio
    for bid in ids:
        a, b = pager.block_meta(bid), jpager.block_meta(bid)
        assert (a["lo"], a["hi"], a["names"]) == (b["lo"], b["hi"],
                                                   b["names"])
        assert open(a["path"], "rb").read() == open(b["path"], "rb").read()
    # one block at a time, then the other two batched
    back = kvcache.page_in_blocks(port, pager, ids[:1])
    jax_ = jkv.page_in_blocks(jax_, jpager, ids[:1])
    assert back is port
    back = kvcache.page_in_blocks_batched(port, pager, ids[1:])
    jax_ = jkv.page_in_blocks_batched(jax_, jpager, ids[1:])
    assert back is port
    _same(port, jax_)
    assert pager.stats == jpager.stats


@pytest.mark.parametrize("batched", [False, True])
def test_lost_block_degrades_as_the_reference(tmp_path, caches, batched):
    port, jax_ = _pair(caches)
    pager = KVPager(str(tmp_path / "port"), codec=_codec())
    jpager = JKVPager(str(tmp_path / "jax"), codec=_jcodec())
    port, ids = kvcache.offload_prefix(port, pager, 16, block_tokens=8)
    jax_, _ = jkv.offload_prefix(jax_, jpager, 16, block_tokens=8)
    for p in (pager, jpager):
        os.unlink(p.block_meta(ids[0])["path"])
    page = (kvcache.page_in_blocks_batched if batched
            else kvcache.page_in_blocks)
    jpage = (jkv.page_in_blocks_batched if batched
             else jkv.page_in_blocks)
    lost, jlost = [], []
    port = page(port, pager, ids, on_lost=lambda b, e: lost.append(b))
    jax_ = jpage(jax_, jpager, ids, on_lost=lambda b, e: jlost.append(b))
    assert lost == jlost == [ids[0]]
    assert not port["k"][:, :, :8].any()
    _same(port, jax_)
    assert pager.stats == jpager.stats and pager.stats["pages_lost"] == 1
    with pytest.raises(PageLostError):
        page(port, pager, ids[:1])


def test_kvcache_names():
    assert kvcache.KVPager is KVPager
    for name in ("CompressedCache", "compress_cache", "decompress_cache",
                 "offload_prefix", "page_in_blocks",
                 "page_in_blocks_batched"):
        assert hasattr(kvcache, name) and hasattr(jkv, name)
