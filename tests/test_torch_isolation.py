"""The PyTorch port stands alone and hides no fallback.

  * No module of ``src/repro_torch/``, no ``examples/torch_*.py`` driver
    and not ``chip_smoke.py`` imports JAX or the JAX package (an AST scan
    of every import).
  * Entry points default to the card: without CUDA a default call raises
    instead of running on the CPU.
  * The kernel wrappers (K1 to K5) reject what their kernels do not
    take — dtype, shape, contiguity, device — on CPU tensors too.
"""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 6
    return files + examples + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_reference():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def _module_level_imports(path: Path):
    """Imports outside every function body of a module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        stack.extend(ast.iter_child_nodes(node))


def test_scan_covers_the_dry_run_and_keeps_the_fake_world_lazy():
    """The dry run's modules are scanned, and no port module imports
    PyTorch's internal testing package (the fake process group) when it
    is imported: only the dry-run functions that make a fake world do."""
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    for mod in ("dryrun", "hlo_stats", "input_specs", "detr_cells"):
        assert f"src/repro_torch/launch/{mod}.py" in names
    lazy = [f"{f.relative_to(ROOT)} imports {m}" for f in _port_files()
            for m in _module_level_imports(f) if m.startswith("torch.testing")]
    assert not lazy, lazy
    probe = ROOT / "src" / "repro_torch" / "launch" / "dryrun.py"
    assert "torch.testing._internal.distributed.fake_pg" in probe.read_text()


def test_scan_detects_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch\nfrom repro.core import nn\n"
                     "import jax.numpy as jnp\n")
    assert [m for _, m in _imported_roots(probe)] == ["repro_torch", "repro",
                                                      "jax"]


def _small_detector():
    from repro_torch.core.detector import DetectorConfig
    from repro_torch.core.encoder import EncoderConfig
    from repro_torch.core.msdeform_attn import MSDeformAttnConfig
    from repro_torch.msda.decoder import MSDADecoderConfig
    attn = MSDeformAttnConfig(d_model=32, n_heads=4)
    return DetectorConfig(encoder=EncoderConfig(attn=attn, n_blocks=1, d_ffn=64),
                          img_size=32, decoder=MSDADecoderConfig(
                              n_layers=1, n_queries=8, d_ffn=64))


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: the default runs there")
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.detector import init_detector
    from repro_torch.serve import DetrServeEngine
    cfg = _small_detector()
    params = init_detector(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        DetrServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_detector(cfg)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})


def _k1_operands(b=1, nq=5, h=2, k=4, dh=16, n_rows=30):
    g = torch.Generator().manual_seed(0)
    v = torch.randn((b, n_rows, h, dh), generator=g)
    x = torch.rand((b, nq, h, k), generator=g) * 4
    y = torch.rand((b, nq, h, k), generator=g) * 4
    st = torch.zeros((b, nq, h, k), dtype=torch.int32)
    wl = torch.full((b, nq, h, k), 5, dtype=torch.int32)
    hl = torch.full((b, nq, h, k), 5, dtype=torch.int32)
    p = torch.softmax(torch.randn((b, nq, h, k), generator=g), -1)
    return v, [x, y, st, wl, hl, p]


def test_k1_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels.msgs_fused import msgs_fused, msgs_fused_packed
    v, pts = _k1_operands()
    assert msgs_fused(v, *pts).shape == (1, 5, 2, 16)
    with pytest.raises(TypeError, match="table dtype"):
        msgs_fused(v.double(), *pts)
    with pytest.raises(TypeError, match="x_px must be torch.float32"):
        msgs_fused(v, pts[0].double(), *pts[1:])
    with pytest.raises(TypeError, match="start must be torch.int32"):
        msgs_fused(v, *pts[:2], pts[2].long(), *pts[3:])
    with pytest.raises(ValueError, match="contiguous"):
        msgs_fused(v.transpose(1, 2).contiguous().transpose(1, 2), *pts)
    with pytest.raises(ValueError, match="contiguous"):
        msgs_fused(v, pts[0].transpose(1, 2).contiguous().transpose(1, 2),
                   *pts[1:])
    with pytest.raises(ValueError, match="shape"):
        msgs_fused(v, pts[0][:, :3].contiguous(), *pts[1:])
    with pytest.raises(ValueError, match="int8 table needs"):
        msgs_fused(v.to(torch.int8), *pts)
    with pytest.raises(ValueError, match="int8 table needs"):
        msgs_fused(v, *pts, scale=torch.ones((1, 1, 2, 16)))
    with pytest.raises(ValueError, match="scale must be"):
        msgs_fused(v.to(torch.int8), *pts, scale=torch.ones((1, 2, 16)))
    with pytest.raises(ValueError, match="remap must be"):
        msgs_fused(v, *pts, remap=torch.zeros((1, 30), dtype=torch.int64))
    with pytest.raises(ValueError, match="head dim"):
        msgs_fused(torch.zeros((1, 30, 1, 160)), *[t[:, :, :1].contiguous()
                                                   for t in pts])
    with pytest.raises(ValueError, match="head_pack"):
        msgs_fused_packed(v, *pts, head_pack=3)


def test_k2_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels.msgs_decode import msgs_decode, stage_decode_table
    v, pts = _k1_operands(h=4)
    staged = stage_decode_table(v, head_pack=2)
    assert msgs_decode(staged, *pts).shape == (1, 5, 4, 16)
    with pytest.raises(ValueError, match="points must be"):
        msgs_decode(staged, *[t[:, :, :2].contiguous() for t in pts])
    with pytest.raises(TypeError, match="probs must be torch.float32"):
        msgs_decode(staged, *pts[:5], pts[5].double())
    bad = stage_decode_table(v.to(torch.int8), head_pack=2)      # no scale
    with pytest.raises(ValueError, match="int8 table needs"):
        msgs_decode(bad, *pts)


def _k3_operands():
    levels = ((4, 5), (2, 3))
    g = torch.Generator().manual_seed(1)
    b, n_in, h, k, dh = 1, 26, 4, 4, 16
    v = torch.randn((b, n_in, h, dh), generator=g)
    x = torch.rand((b, n_in, h, k), generator=g) * 4
    y = torch.rand((b, n_in, h, k), generator=g) * 3
    lvl = torch.randint(0, 2, (b, n_in, h, k), generator=g, dtype=torch.int32)
    p = torch.softmax(torch.randn((b, n_in, h, k), generator=g), -1)
    return v, [x, y, lvl, p], dict(level_shapes=levels, ranges=(2.0, 1.0),
                                    tile_q=8)


def test_k3_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels.msgs_windowed import msgs_windowed_msp
    v, pts, kw = _k3_operands()
    assert msgs_windowed_msp(v, *pts, **kw).shape == (1, 26, 4, 16)
    with pytest.raises(TypeError, match="table dtype"):
        msgs_windowed_msp(v.double(), *pts, **kw)
    with pytest.raises(TypeError, match="lvl_of_pt must be torch.int32"):
        msgs_windowed_msp(v, *pts[:2], pts[2].long(), pts[3], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        msgs_windowed_msp(v, pts[0].transpose(1, 2).contiguous().transpose(1, 2),
                          *pts[1:], **kw)
    with pytest.raises(ValueError, match="raster encoder queries"):
        msgs_windowed_msp(v[:, :20].contiguous(),
                          *[t[:, :20].contiguous() for t in pts], **kw)
    with pytest.raises(ValueError, match="head_pack"):
        msgs_windowed_msp(v, *pts, head_pack=3, **kw)
    with pytest.raises(ValueError, match="scale must be"):
        msgs_windowed_msp(v.to(torch.int8), *pts,
                          scale=torch.ones((1, 1, 4, 16)), head_pack=2, **kw)
    with pytest.raises(ValueError, match="int8 table needs"):
        msgs_windowed_msp(v.to(torch.int8), *pts, **kw)
    remap = torch.zeros((1, 26), dtype=torch.int32)
    with pytest.raises(ValueError, match="both remap and keep_idx"):
        msgs_windowed_msp(v, *pts, remap=remap, **kw)
    with pytest.raises(ValueError, match="keep_idx must be"):
        msgs_windowed_msp(v, *pts, remap=remap,
                          keep_idx=torch.zeros((1, 9), dtype=torch.int64), **kw)
    with pytest.raises(ValueError, match="remap covers"):
        msgs_windowed_msp(v, *pts, remap=remap[:, :20].contiguous(),
                          keep_idx=torch.zeros((1, 9), dtype=torch.int32), **kw)


def _k5_operands(b=2, hq=6, hkv=2, dh=16, w=10):
    g = torch.Generator().manual_seed(2)
    return (torch.randn((b, hq, dh), generator=g),
            torch.randn((b, w, hkv, dh), generator=g),
            torch.randn((b, w, hkv, dh), generator=g),
            torch.rand((b, w), generator=g) < 0.7)


def test_k5_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, valid = _k5_operands()
    assert flash_decode(q, k, v, valid).shape == (2, 6, 16)
    with pytest.raises(TypeError, match="dtype"):
        flash_decode(q.double(), k.double(), v.double(), valid)
    with pytest.raises(TypeError, match="share one dtype"):
        flash_decode(q, k.to(torch.bfloat16), v, valid)
    with pytest.raises(ValueError, match=r"q must be \(B, Hq, Dh\)"):
        flash_decode(q[:, None], k, v, valid)
    with pytest.raises(ValueError, match="does not match q"):
        flash_decode(q[:1], k, v, valid)
    with pytest.raises(ValueError, match=r"valid must be bool \(B=2, W=10\)"):
        flash_decode(q, k, v, valid[:, :9])
    with pytest.raises(ValueError, match="valid must be bool"):
        flash_decode(q, k, v, valid.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, valid)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(torch.zeros((1, 2, 160)), torch.zeros((1, 4, 1, 160)),
                     torch.zeros((1, 4, 1, 160)), torch.ones((1, 4), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_decode(q.requires_grad_(), k, v, valid)


def test_k4_wrapper_rejects_unsupported_operands():
    from repro_torch.kernels.matmul import matmul
    g = torch.Generator().manual_seed(3)
    x, w = torch.randn((5, 7), generator=g), torch.randn((7, 3), generator=g)
    wq, s = (w * 20).round().to(torch.int8), torch.full((1, 3), 0.05)
    assert matmul(x, w).shape == (5, 3) and matmul(x, wq, s).shape == (5, 3)
    with pytest.raises(TypeError, match="x dtype"):
        matmul(x.double(), w.double())
    with pytest.raises(TypeError, match="w dtype"):
        matmul(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r"expected x \(M, K\)"):
        matmul(x[None], w)
    with pytest.raises(ValueError, match=r"expected x \(M, K\)"):
        matmul(x[:, :6], w)
    with pytest.raises(ValueError, match="int8 w needs"):
        matmul(x, wq)
    with pytest.raises(ValueError, match="int8 w needs"):
        matmul(x, w, s)
    with pytest.raises(ValueError, match="w_scale must be"):
        matmul(x, wq, s[0])
    with pytest.raises(ValueError, match="contiguous"):
        matmul(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="tile sizes"):
        matmul(x, w, bk=0)


TP_MODULES = ("repro_torch.distributed.act_sharding",
              "repro_torch.distributed.collectives",
              "repro_torch.models.layers", "repro_torch.models.decoder",
              "repro_torch.models.encdec", "repro_torch.models.registry",
              "repro_torch.launch.input_specs", "repro_torch.launch.dryrun")


def test_tensor_parallel_modules_are_scanned_and_import_alone():
    """The modules of the tensor-parallel serving path are in the scan,
    and importing them in a fresh interpreter loads neither JAX nor the
    reference."""
    import os
    import subprocess
    import sys
    names = {f.relative_to(ROOT).as_posix() for f in _port_files()}
    for mod in TP_MODULES:
        assert "src/" + mod.replace(".", "/") + ".py" in names, mod
    probe = ("import sys\n" + "".join(f"import {m}\n" for m in TP_MODULES)
             + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120, env=dict(
                             os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]", out.stdout
