"""The port's checkpoint store and tree helpers against the JAX reference.

  * ``repro_torch.utils.tree`` equals ``repro.utils.tree`` on a converted
    detector tree and on a train state;
  * save -> load -> ``restore_into`` is bitwise for float32, int32, int8
    and bfloat16 leaves in nested dict / list / NamedTuple trees, onto the
    template leaf's dtype;
  * a crash mid-write leaves a ``.tmp-`` directory that ``latest_step``
    ignores; ``keep`` pruning; ``AsyncCheckpointer.wait`` returns only
    after the write has finished (a writer slowed by a patched
    ``np.save``), where the reference's ``wait`` returns early;
  * across packages: the port's files are the reference's byte for byte;
    a store the reference writes restores bitwise in the port (a bfloat16
    leaf too, which the reference's own ``restore_into`` cannot cast back:
    asserted as a recorded property), and a store the port writes loads
    in the reference with the same bytes.

Tolerances: none; every comparison is exact (bitwise for floats).
"""
import os
import threading
import time
from typing import Any, NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as rstore  # noqa: E402
from repro.core import detector as rdet, encoder as renc  # noqa: E402
from repro.core import msdeform_attn as rattn  # noqa: E402
from repro.msda import decoder as rdec  # noqa: E402
from repro.utils import tree as rtree  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)

TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                "int8": torch.int8, "bfloat16": torch.bfloat16}


class Pair(NamedTuple):
    params: Any
    step: Any


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a tensor, for bitwise comparison."""
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def _ref_bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.reshape(-1).view(np.uint8)


def _sample(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return (torch.randn(shape, generator=g) * 3).to(dtype)
    lo, hi = (-128, 128) if dtype == torch.int8 else (-2**31, 2**31 - 1)
    return torch.randint(lo, hi, shape, generator=g, dtype=torch.int64).to(dtype)


def _nested(dtype: torch.dtype) -> Pair:
    return Pair(params={"blocks": [{"w": _sample(dtype, (3, 5), 0),
                                    "b": _sample(dtype, (5,), 1)},
                                   {"w": _sample(dtype, (3, 5), 2),
                                    "b": _sample(dtype, (5,), 3)}],
                        "pair": (_sample(dtype, (2, 2, 2), 4),
                                 _sample(dtype, (), 5)),
                        "head": {"w": _sample(dtype, (4, 1), 6)}},
                step=torch.tensor(7, dtype=torch.int32))


def _leaves(t):
    return [leaf for _, leaf in tree._leaves_with_path(t)]


def _ref_detector_cfg():
    attn = rattn.MSDeformAttnConfig(d_model=32, n_heads=2, n_levels=4,
                                    n_points=2)
    return rdet.DetectorConfig(
        encoder=renc.EncoderConfig(attn=attn, n_blocks=2, d_ffn=64),
        img_size=32, decoder=rdec.MSDADecoderConfig(n_layers=2, n_queries=12,
                                                    d_ffn=64))


@pytest.fixture(scope="module")
def detector_trees():
    ref = jax.tree.map(np.asarray,
                       rdet.init_detector(jax.random.PRNGKey(0),
                                          _ref_detector_cfg()))
    return ref, params_from_numpy(ref, device="cpu")


# --------------------------------------------------------------------------
# tree helpers
# --------------------------------------------------------------------------

def test_flatten_and_unflatten_equal_the_reference(detector_trees):
    ref, port = detector_trees
    r_flat, p_flat = rtree.flatten_dict(ref), tree.flatten_dict(port)
    assert list(r_flat) == list(p_flat)
    for k in r_flat:
        if isinstance(r_flat[k], list):           # a list is a leaf of both
            assert isinstance(p_flat[k], list) and len(p_flat[k]) == len(r_flat[k])
        else:
            np.testing.assert_array_equal(p_flat[k].numpy(), r_flat[k])
    back = tree.unflatten_dict(p_flat)
    assert list(rtree.unflatten_dict(r_flat)) == list(back)
    nested = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert tree.flatten_dict(nested, sep=".") == rtree.flatten_dict(nested, sep=".")
    assert tree.unflatten_dict(tree.flatten_dict(nested)) == nested


def test_size_and_bytes_equal_the_reference(detector_trees):
    ref, port = detector_trees
    assert tree.tree_size(port) == rtree.tree_size(ref) > 1000
    assert tree.tree_bytes(port) == rtree.tree_bytes(ref) == 4 * rtree.tree_size(ref)
    mixed_ref = {"a": jnp.ones((3, 4), jnp.bfloat16), "b": [np.int8([1, 2])],
                 "c": 5}
    mixed = {"a": torch.ones((3, 4), dtype=torch.bfloat16),
             "b": [torch.tensor([1, 2], dtype=torch.int8)], "c": 5}
    assert tree.tree_size(mixed) == rtree.tree_size(mixed_ref) == 15
    assert tree.tree_bytes(mixed) == rtree.tree_bytes(mixed_ref) == 26


def test_path_strings_equal_the_reference(detector_trees):
    ref, port = detector_trees
    r_keys = jax.tree.leaves(rtree.tree_map_with_path_str(lambda k, v: k, ref))
    p_keys = [leaf for _, leaf in tree._leaves_with_path(
        tree.tree_map_with_path_str(lambda k, v: k, port))]
    assert p_keys == r_keys
    assert "encoder/blocks/0/attn/attn_w" in p_keys
    pair_ref = Pair({"w": jnp.ones(2), "s": [jnp.ones(1)]}, jnp.zeros(()))
    pair = Pair({"w": torch.ones(2), "s": [torch.ones(1)]}, torch.zeros(()))
    mapped = tree.tree_map_with_path_str(lambda k, v: k, pair)
    assert isinstance(mapped, Pair)
    assert mapped == rtree.tree_map_with_path_str(lambda k, v: k, pair_ref)


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_roundtrip_is_bitwise(tmp_path, dtype):
    state = _nested(TORCH_DTYPES[dtype])
    path = store.save_checkpoint(str(tmp_path), 5, state)
    assert os.path.basename(path) == "step_00000005"
    assert store.latest_step(str(tmp_path)) == 5
    step, loaded = store.load_checkpoint(str(tmp_path))
    assert step == 5
    assert sorted(loaded["params"]["blocks"]) == ["__seq0", "__seq1"]
    restored = store.restore_into(state, loaded)
    assert isinstance(restored, Pair)
    assert isinstance(restored.params["blocks"], list)
    assert isinstance(restored.params["pair"], tuple)
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_restore_takes_the_template_dtype(tmp_path):
    saved = {"w": torch.tensor([1.5, -2.25, 3.0])}
    store.save_checkpoint(str(tmp_path), 1, saved)
    _, loaded = store.load_checkpoint(str(tmp_path))
    tmpl = {"w": torch.zeros(3, dtype=torch.float64)}
    got = store.restore_into(tmpl, loaded)["w"]
    assert got.dtype == torch.float64
    assert got.tolist() == [1.5, -2.25, 3.0]
    as_np = store.restore_into({"w": np.zeros(3, np.float32)}, loaded)["w"]
    assert isinstance(as_np, np.ndarray) and as_np.dtype == np.float32


def test_crash_mid_write_leaves_a_tmp_dir_that_latest_step_ignores(
        tmp_path, monkeypatch):
    good = _nested(torch.float32)
    store.save_checkpoint(str(tmp_path), 4, good)
    calls = {"n": 0}
    real = np.save

    def failing_save(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise OSError("disk lost mid-write")
        return real(*a, **kw)
    monkeypatch.setattr(np, "save", failing_save)
    with pytest.raises(OSError):
        store.save_checkpoint(str(tmp_path), 8, good)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000004", f"step_00000008.tmp-{os.getpid()}"]
    assert store.latest_step(str(tmp_path)) == 4
    # a directory without a manifest is no checkpoint either
    os.makedirs(tmp_path / "step_00000009")
    assert store.latest_step(str(tmp_path)) == 4
    step, loaded = store.load_checkpoint(str(tmp_path))
    assert step == 4
    for a, b in zip(_leaves(store.restore_into(good, loaded)), _leaves(good)):
        assert torch.equal(a, b)


def test_no_checkpoint(tmp_path):
    assert store.latest_step(str(tmp_path / "missing")) is None
    assert store.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        store.load_checkpoint(str(tmp_path))


def test_async_writer_keeps_the_newest(tmp_path):
    ck = store.AsyncCheckpointer(str(tmp_path), keep=2)
    state = _nested(torch.float32)
    for s in (2, 4, 6, 8):
        ck.save(s, state)
    ck.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000006", "step_00000008"]
    assert len(ck.snapshot_s) == len(ck.write_s) == 4
    ck.close()                                   # idempotent


def test_async_snapshot_is_taken_at_save(tmp_path):
    w = torch.zeros(4)
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(1, {"w": w})
    w.add_(1.0)                                  # after the snapshot
    ck.close()
    _, loaded = store.load_checkpoint(str(tmp_path), 1)
    assert torch.equal(loaded["w"], torch.zeros(4))


def _slow_np_save(monkeypatch, seconds):
    real = np.save

    def slow(*a, **kw):
        time.sleep(seconds)
        return real(*a, **kw)
    monkeypatch.setattr(np, "save", slow)


@pytest.mark.parametrize("exit_call", ["wait", "close"])
def test_async_wait_returns_only_after_the_write(tmp_path, monkeypatch,
                                                 exit_call):
    _slow_np_save(monkeypatch, 0.05)
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    state = _nested(torch.float32)               # 7 leaves: >= 0.35 s
    ck.save(3, state)
    assert ck.busy
    waiter = threading.Thread(target=getattr(ck, exit_call))
    waiter.start()
    waiter.join(timeout=30)
    assert not waiter.is_alive() and not ck.busy
    assert os.path.exists(tmp_path / "step_00000003" / "manifest.json")
    assert store.latest_step(str(tmp_path)) == 3
    ck.close()


def test_reference_wait_returns_before_the_write(tmp_path, monkeypatch):
    """A recorded property of the reference: its ``wait`` polls
    ``Queue.empty()``, true once the writer has taken the item, so it
    returns while the write is still running."""
    _slow_np_save(monkeypatch, 0.2)
    ck = rstore.AsyncCheckpointer(str(tmp_path), keep=3)
    ck.save(3, {"a": np.ones(2), "b": np.ones(3)})
    time.sleep(0.05)                             # the writer takes the item
    ck.wait()
    assert not os.path.exists(tmp_path / "step_00000003" / "manifest.json")
    ck.close()


def test_async_error_surfaces_on_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("no space left")
    ck = store.AsyncCheckpointer(str(tmp_path), keep=3)
    monkeypatch.setattr(np, "save", broken)
    ck.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    with pytest.raises(OSError, match="no space"):
        ck.save(2, {"w": torch.ones(2)})
    monkeypatch.undo()
    with pytest.raises(OSError):
        ck.close()
    assert not ck._t.is_alive()


# --------------------------------------------------------------------------
# across packages
# --------------------------------------------------------------------------

def _ref_tree(dtype: str):
    """The reference's counterpart of ``_nested``: the same values."""
    port = _nested(TORCH_DTYPES[dtype])

    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return rdet_tree_map(conv, port), port


def rdet_tree_map(fn, pair: Pair) -> Pair:
    p = pair.params
    return Pair(params={"blocks": [{k: fn(v) for k, v in b.items()}
                                   for b in p["blocks"]],
                        "pair": tuple(fn(v) for v in p["pair"]),
                        "head": {"w": fn(p["head"]["w"])}},
                step=fn(pair.step))


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_files_are_the_references_byte_for_byte(tmp_path, dtype):
    ref, port = _ref_tree(dtype)
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    rstore.save_checkpoint(str(rdir), 12, ref)
    store.save_checkpoint(str(pdir), 12, port)
    rpath, ppath = rdir / "step_00000012", pdir / "step_00000012"
    names = sorted(os.listdir(rpath))
    assert names == sorted(os.listdir(ppath))
    assert "params__blocks____seq1__w.npy" in names
    for n in names:
        assert (rpath / n).read_bytes() == (ppath / n).read_bytes(), n


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_reference_store_restores_bitwise_in_the_port(tmp_path, dtype):
    ref, port = _ref_tree(dtype)
    rstore.save_checkpoint(str(tmp_path), 3, ref)
    step, loaded = store.load_checkpoint(str(tmp_path))
    assert step == 3
    template = jax.tree.map(torch.zeros_like, port)
    restored = store.restore_into(template, loaded)
    for a, r in zip(_leaves(restored), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(_bits(a), _ref_bits(r))


def test_reference_cannot_restore_its_own_bfloat16_leaf(tmp_path):
    """A recorded property of the reference: a bfloat16 leaf comes back
    from ``np.load`` as a 2-byte void array, which its ``restore_into``
    cannot cast to the template's bfloat16."""
    ref, _ = _ref_tree("bfloat16")
    rstore.save_checkpoint(str(tmp_path), 1, ref)
    _, loaded = rstore.load_checkpoint(str(tmp_path))
    assert loaded["params"]["head"]["w"].dtype == np.dtype("V2")
    with pytest.raises((ValueError, TypeError)):
        rstore.restore_into(ref, loaded)


@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_port_store_loads_in_the_reference(tmp_path, dtype):
    ref, port = _ref_tree(dtype)
    store.save_checkpoint(str(tmp_path), 6, port)
    step, loaded = rstore.load_checkpoint(str(tmp_path))
    assert step == 6
    flat = rtree.flatten_dict(loaded)
    want = store._to_host(port)
    assert list(flat) == list(want)
    for k, t in want.items():
        got = flat[k]
        assert list(got.shape) == list(t.shape)
        if dtype == "bfloat16" and k != "step":   # the same 2-byte payload
            assert got.dtype == np.dtype("V2")
        else:
            np.testing.assert_array_equal(got, t.numpy())
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8), _bits(t))
    if dtype != "bfloat16":
        restored = rstore.restore_into(ref, loaded)
        for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
