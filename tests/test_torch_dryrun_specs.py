"""The port's dry-run cells (``repro_torch.launch.input_specs.build_cell``,
``launch.detr_cells.build_detr_cell`` / ``build_banded_detr_cell``)
against the reference's, on both production meshes.

The reference builds each cell on a ``jax.sharding.AbstractMesh`` (no
devices); the port on an ``InProcessMesh`` of the same shape (no process
group). For every LM cell (the ten architectures × ``shapes_for``) and
every DETR cell (serve and train of three configs, the banded serve of
deformable-detr-defa): ``meta`` and ``donate`` equal, the same input
leaves in the same order with the same global shape and dtype, and each
leaf's shard on rank 0 and on the last rank (``collectives.local_slices``)
of the shape ``NamedSharding(mesh, spec).shard_shape`` gives. All exact.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as r_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as R_SHAPES  # noqa: E402
from repro.launch.detr_cells import (  # noqa: E402
    build_banded_detr_cell as r_build_banded, build_detr_cell as r_build_detr)
from repro.launch.input_specs import build_cell as r_build_cell  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, shapes_for  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    InProcessMesh, local_slices)
from repro_torch.distributed.sharding import is_spec  # noqa: E402
from repro_torch.launch.detr_cells import (  # noqa: E402
    build_banded_detr_cell, build_detr_cell)
from repro_torch.launch.input_specs import build_cell  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
LM_CELLS = [(arch, s) for arch in ARCH_IDS
            for s in shapes_for(get_config(arch).family)]
DETR_CELLS = [("deformable-detr", "serve"), ("deformable-detr", "train"),
              ("deformable-detr-defa", "serve"),
              ("deformable-detr-defa", "train"),
              ("deformable-detr-defa", "banded"),
              ("dino", "serve"), ("dino", "train")]


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def ref_leaves(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [("/".join(_key(k) for k in path), leaf) for path, leaf in flat]


def port_leaves(tree, is_leaf, path=()):
    """(path, leaf) in jax.tree order: dict keys sorted, NamedTuple
    fields and sequences in order."""
    if tree is None:
        return []
    if is_leaf(tree):
        return [("/".join(str(p) for p in path), tree)]
    if hasattr(tree, "_asdict"):
        items = list(tree._asdict().items())
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        items = list(enumerate(tree))
    return [x for k, v in items for x in port_leaves(v, is_leaf, path + (k,))]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def check_cell(ref, port, mesh_shape, names):
    assert port.meta == {**ref.meta, "mesh": dict(ref.meta["mesh"])}
    assert tuple(port.donate) == tuple(ref.donate)
    sizes = dict(zip(names, mesh_shape))
    first = {a: 0 for a in names}
    last = {a: s - 1 for a, s in sizes.items()}
    r_sds = ref_leaves(ref.in_sds)
    r_sh = ref_leaves(ref.in_shardings,
                      is_leaf=lambda x: isinstance(x, NamedSharding))
    p_sds = port_leaves(port.in_specs, lambda x: isinstance(x, torch.Tensor))
    p_sh = port_leaves(port.in_shardings, is_spec)
    assert [p for p, _ in p_sds] == [p for p, _ in r_sds]
    assert len(p_sh) == len(r_sh) == len(r_sds)
    for (path, rs), (_, rsh), (_, pt), (_, psp) in zip(r_sds, r_sh, p_sds,
                                                       p_sh):
        shape = tuple(rs.shape)
        assert tuple(pt.shape) == shape, path
        assert pt.device.type == "meta", path
        assert dtype_name(pt.dtype) == str(rs.dtype), path
        want = tuple(rsh.shard_shape(shape))
        for index in (first, last):
            sl = local_slices(psp, shape, sizes, index)
            got = tuple(len(range(*s.indices(n))) for s, n in zip(sl, shape))
            assert got == want, (path, psp, rsh.spec)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", LM_CELLS)
def test_lm_cell_specs(arch, shape, mesh_kind):
    mesh_shape, names = MESHES[mesh_kind]
    ref = r_build_cell(arch, r_get_config(arch), R_SHAPES[shape],
                       AbstractMesh(mesh_shape, names))
    port = build_cell(arch, get_config(arch), SHAPES[shape],
                      InProcessMesh(mesh_shape, names))
    assert port.name == ref.name
    check_cell(ref, port, mesh_shape, names)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("name,kind", DETR_CELLS)
def test_detr_cell_specs(name, kind, mesh_kind):
    mesh_shape, names = MESHES[mesh_kind]
    amesh, pmesh = AbstractMesh(mesh_shape, names), InProcessMesh(mesh_shape,
                                                                  names)
    if kind == "banded":
        ref, port = r_build_banded(name, amesh), build_banded_detr_cell(name,
                                                                        pmesh)
    else:
        ref, port = r_build_detr(name, kind, amesh), build_detr_cell(
            name, kind, pmesh)
    assert port.name == ref.name
    check_cell(ref, port, mesh_shape, names)
