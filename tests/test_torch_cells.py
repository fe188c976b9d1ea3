"""The port's cells, FLOP and traffic models and production mesh against
the reference's, on the CPU.

Every (arch x shape) cell is built by both packages on a (1, 1) and a
(4, 2) mesh (the reference's on a ``jax.sharding.AbstractMesh``, the
port's on a CPU ``Mesh``): kind, notes, ``donate_argnums`` and
``model_flops`` equal (``==``), the argument trees alike in structure,
every leaf of the same shape and dtype, every partition spec equal, and
every port leaf a ``meta`` tensor (a cell allocates nothing).
``flops.model_flops`` and ``traffic.analytic_bytes`` equal the
reference's (``==``) for every cell at 1, 8, 256 and 512 chips.
``make_production_mesh`` has the reference's shapes and axes on
``meta``, and refuses ``cuda`` without the cards.
"""
import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_arch as jget_arch
from repro.launch import cells as jcells
from repro.launch import flops as jflops
from repro.launch import traffic as jtraffic
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import cells, flops, traffic
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.common import NamedSharding

CELLS = [(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
MESHES = {"1x1": (1, 1), "4x2": (4, 2)}
AXES = ("data", "model")


def _walk(tree, path, out, leaf_type):
    """(``jax.tree_util.keystr``-like path, leaf) pairs in its order:
    dict keys sorted, sequences by index, dataclass fields by position."""
    if isinstance(tree, leaf_type):
        out.append((path, tree))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _walk(tree[k], f"{path}[{k!r}]", out, leaf_type)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            _walk(x, f"{path}[{i}]", out, leaf_type)
    elif dataclasses.is_dataclass(tree):
        # the reference registers its dataclasses by field position
        for i, f in enumerate(dataclasses.fields(tree)):
            _walk(getattr(tree, f.name), f"{path}[<flat index {i}>]", out,
                  leaf_type)
    return out


def _canon(spec) -> tuple:
    """A partition spec as ``PartitionSpec`` keeps it: an entry naming
    one axis as a 1-tuple is that axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jwalk(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), x) for p, x in flat]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_matches_reference(arch, shape, mesh):
    want = jcells.build_cell(arch, shape, AbstractMesh(MESHES[mesh], AXES))
    got = cells.build_cell(arch, shape,
                           make_host_mesh(MESHES[mesh], AXES, device="cpu"))
    assert (got.kind, got.notes, got.donate_argnums) == (
        want.kind, want.notes, want.donate_argnums)
    assert got.model_flops == want.model_flops
    args_w, args_g = _jwalk(want.args), _walk(got.args, "", [], torch.Tensor)
    assert [p for p, _ in args_g] == [p for p, _ in args_w]
    for (p, g), (_, w) in zip(args_g, args_w):
        assert tuple(g.shape) == tuple(w.shape), p
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), p
        assert g.device.type == "meta", p
    sh_w = _jwalk(want.in_shardings)
    sh_g = _walk(got.in_shardings, "", [], NamedSharding)
    assert [p for p, _ in sh_g] == [p for p, _ in sh_w]
    for (p, g), (_, w) in zip(sh_g, sh_w):
        assert _canon(g.spec) == _canon(w.spec), p


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_and_traffic_equal_reference(arch, shape):
    spec, jspec = get_arch(arch), jget_arch(arch)
    cell, jcell = spec.shape(shape), jspec.shape(shape)
    assert flops.model_flops(spec, cell) == jflops.model_flops(jspec, jcell)
    for n_chips in (1, 8, 256, 512):
        for tp in (1, 16) if n_chips >= 16 else (1,):
            assert traffic.analytic_bytes(spec, cell, n_chips, tp=tp) == \
                jtraffic.analytic_bytes(jspec, jcell, n_chips, tp=tp)


@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh(multi):
    m = make_production_mesh(multi_pod=multi)
    if multi:
        assert (m.shape, m.axis_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    else:
        assert (m.shape, m.axis_names) == ((16, 16), ("data", "model"))
    assert m.size == (512 if multi else 256)
    assert {d.type for d in m.devices} == {"meta"}


def test_production_mesh_on_cuda_needs_the_cards():
    with pytest.raises(RuntimeError):
        make_production_mesh(device="cuda")
