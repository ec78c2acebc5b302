"""The paged pool cut into page blocks over a mesh's data ranks, on the
CPU: each of D virtual ranks' compacted table and local lengths
(``models/attention.py::_owned_table``), its partials
(``ref.paged_decode_partials_ref`` through ``ops``) and the merge of
every rank's (``ref.decode_merge_ref``) against the JAX Pallas kernel in
interpret mode and the plain decode over the whole pool; the masked
write of a rank's own pages; and the port's specs of the paged tree
against the reference's, with the block ``sharding.page_block`` gives.

Inputs are numpy arrays from a seed, fed to both packages."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs
from repro.kernels.decode_attention import \
    paged_flash_decode as jax_paged_flash_decode
from repro.launch import sharding as jsh
from repro.models.transformer import init_paged_states as jax_paged_states
from repro_torch.kernels import decode_attention, ops, ref
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import attention
from repro_torch.models.transformer import init_paged_states

TOL = 1e-5
P, KV, H, HD, PS, W = 16, 2, 12, 32, 8, 6
# lanes' lengths and pages: length 0 on the null table, partial last
# pages, a lane wholly in block 2 of 4, one spread over every block, a
# lane of whole pages, and one position
LANES = [(0, [0] * W),
         (21, [5, 4, 14, 0, 0, 0]),
         (19, [8, 10, 11, 0, 0, 0]),
         (44, [1, 13, 7, 3, 12, 9]),
         (24, [2, 15, 6, 0, 0, 0]),
         (1, [12, 0, 0, 0, 0, 0])]


def _case(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((len(LANES), H, HD)).astype(np.float32)
    kp = rng.standard_normal((P, KV, PS, HD)).astype(np.float32)
    vp = rng.standard_normal((P, KV, PS, HD)).astype(np.float32)
    tables = np.asarray([t for _, t in LANES], np.int32)
    lengths = np.asarray([n for n, _ in LANES], np.int32)
    return q, kp, vp, tables, lengths


def _ranks(q, kp, vp, tables, n, D):
    """Each of D virtual ranks' (compacted table, local lengths, partials
    through ``ops``) over its block of P / D pages."""
    Pl = P // D
    out = []
    for d in range(D):
        table, length = attention._owned_table(tables, n, PS, d * Pl, Pl)
        part = ops.paged_flash_decode_partials(
            q, kp[d * Pl:(d + 1) * Pl], vp[d * Pl:(d + 1) * Pl], table,
            length)
        out.append((table, length, part))
    return out


@pytest.mark.parametrize("D", [1, 2, 4])
def test_partials_over_page_blocks_merge_to_the_pallas_kernel(D):
    """The merged partials of D page blocks = the Pallas kernel over the
    whole pool (every lane, length 0's zeros included) and the plain
    decode (every live lane) within 1e-5 in f32; each rank's table lists
    the lane's pages in its block in order, its lengths sum to the lane's,
    and only a lane's last page is partial."""
    q, kp, vp, tables, lengths = _case()
    want = np.asarray(jax_paged_flash_decode(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)),
        interpret=True))
    tq, tk, tv, tt, tl = (torch.from_numpy(a) for a in
                          (q, kp, vp, tables, lengths))
    parts = _ranks(tq, tk, tv, tt, tl, D)
    acc, m, l = (torch.cat([p[2][i] for p in parts], 2) for i in range(3))
    got = ref.decode_merge_ref(acc, m, l, torch.float32).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    live = lengths > 0
    plain = ref.paged_decode_ref(tq, tk, tv, tt, tl).numpy()
    np.testing.assert_allclose(got[live], plain[live], atol=TOL, rtol=TOL)
    assert not got[~live].any()

    Pl = P // D
    local = torch.stack([p[1] for p in parts])          # (D, B)
    np.testing.assert_array_equal(local.sum(0).numpy(), lengths)
    for b, (n, pages) in enumerate(LANES):
        used = pages[:-(-n // PS)]
        for d, (table, length, _) in enumerate(parts):
            mine = [pg - d * Pl for pg in used if pg // Pl == d]
            assert table[b, :len(mine)].tolist() == mine
            assert not table[b, len(mine):].any()
            held = sum(min(PS, n - j * PS) for j, pg in enumerate(used)
                       if pg // Pl == d)
            assert int(length[b]) == held
    if D == 4:                                  # lane 2 lies in block 2
        assert [int(p[1][2]) for p in parts] == [0, 0, 19, 0]
        assert all(int(p[1][3]) > 0 for p in parts)
        empty = torch.isinf(parts[0][2][1][2])
        assert empty.all() and not parts[0][2][0][2].any()


def test_one_block_is_the_whole_pool():
    """D = 1: the compacted table is the lane's pages and its length the
    lane's, so the split pass then the merge is the one-call decode's
    split plan over the same positions."""
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _case(1))
    ((table, length, (acc, m, l)),) = _ranks(q, kp, vp, tables, lengths, 1)
    np.testing.assert_array_equal(length.numpy(), lengths.numpy())
    per, n = decode_attention.split_plan(len(LANES), KV, W * PS, PS)
    assert acc.shape == (len(LANES), KV, n, H // KV, HD) and per % PS == 0
    live = lengths > 0
    got = ops.decode_merge(acc, m, l, torch.float32)
    want = ops.paged_flash_decode(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got[live], want[live], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_owned_writes_equal_the_whole_pool_write(D):
    """``_put_owned`` on every virtual rank's block, rows meeting at one
    place included (idle lanes on the null page, and rows another rank
    owns), leaves the blocks equal to one write into the whole pool."""
    rng = np.random.default_rng(2)
    pool = torch.from_numpy(rng.standard_normal((P, KV, PS, HD))
                            .astype(np.float32))
    page = torch.tensor([0, 0, 9, 3, 14, 0, 5, 12])
    slot = torch.tensor([0, 0, 2, 7, 0, 0, 3, 5])
    vals = torch.from_numpy(rng.standard_normal((8, KV, HD))
                            .astype(np.float32))
    vals[1] = vals[0] = vals[5]                 # one value on the null page
    whole = pool.clone()
    whole[page, :, slot] = vals
    Pl = P // D
    blocks = [pool[d * Pl:(d + 1) * Pl].clone() for d in range(D)]
    for d, blk in enumerate(blocks):
        attention._put_owned(blk, page, slot, vals, d * Pl)
    assert torch.equal(torch.cat(blocks), whole)


@pytest.mark.parametrize("mesh", [
    ("data", "model", 4, 2), ("data", "model", 16, 16),
    ("data", "model", 3, 1), ("pod", "data", 2, 4)])
def test_paged_specs_match_the_reference(mesh):
    """The port's ``state_pspecs`` of its per-layer paged tree = the
    reference's of its stacked tree (without the stacked layer dim), per
    layer: the pages over the data axes where they divide 64, nothing
    over "model"."""
    a0, a1, s0, s1 = mesh
    shape = {a0: s0, a1: s1}
    if "model" not in shape:
        shape["model"] = 2
    names = tuple(shape)
    ns = types.SimpleNamespace(shape=shape, axis_names=names)
    jcfg, tcfg = configs(num_layers=3)
    jst = jax_paged_states(jcfg, 64, 16, make=jax.ShapeDtypeStruct)
    flat, _ = jax.tree_util.tree_flatten_with_path(jsh.state_pspecs(
        jst, ns), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = set()
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        want.add(tuple(spec)[1:] if "scan" in keys else tuple(spec))
    tst = init_paged_states(tcfg, 64, 16, torch.device("meta"))
    got = sharding.state_pspecs(tst, ns)
    assert len(got) == tcfg.num_layers
    assert {s for layer in got for s in layer.values()} == want
    dp = sharding.data_axes(ns)
    D = sharding.axes_size(ns, dp)
    cut = got[0]["k_pages"][0]
    assert (cut is not None) == (64 % D == 0)
    assert not any("model" in sharding._axes(e) for s in want for e in s)


def test_page_block_on_the_smoke_mesh():
    """The 1 x 1 mesh's one data rank holds every page in one block (so
    the engine takes the cut path there), and its report says so."""
    mesh = make_smoke_mesh("cpu")
    assert sharding.page_block(mesh, 11) == (0, 11)
    cache = {"k_pages": torch.zeros((11, 1, 4, 16))}
    ctx = sharding.ShardingContext(mesh)
    with sharding.use(ctx):
        assert attention._pages(cache, 11) == (0, 11)
        with pytest.raises(ValueError):
            attention._pages(cache, 12)
    assert sharding.placement_report(ctx)[""]["kv_pages"] == "data=split"
