"""The port's placement on gloo meshes (1, 4), (2, 2) and (4, 1): every
rank's blocks of the params and of a dense slot pool against the
reference's partition specs (``repro.launch.sharding``), the round trip
through ``unplace_params``, and each rank's placed bytes against the dry
run's ``argument_bytes``; and the plain split and merge passes of
``flash_decode`` over a ring cut in slices, one of them empty, against
the whole ring's decode (the port's plain version and the reference's
oracle)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import _flat, placement_rank, run_ranks
from _torch_parity import configs, params_pair
from repro.kernels import ref as jref
from repro.launch import sharding as jsh
from repro_torch.kernels import decode_attention, ops, ref
from repro_torch.launch import specs
from repro_torch.models.transformer import init_layer_states

MESHES = [(1, 4), (2, 2), (4, 1)]
SLOTS = 4
# (arch, layers, overrides, pool depth): qwen2's KV heads (2) gathered on
# 4 "model" ranks; a 2-head qwen2 cut mid-head there (2 x 128 columns
# over 4); recurrentgemma's local-attention ring (64 slots) cut over
# "model"; musicgen's int8 ring and its scales, codebook tables and
# heads; xLSTM's mLSTM and sLSTM (recurrent states: the slot cut only)
ARCHS = {"qwen2": ("qwen2-1.5b", 2, {}, 40),
         "qwen2_h2": ("qwen2-1.5b", 2, dict(num_heads=2, num_kv_heads=1,
                                            head_dim=128), 40),
         "rg": ("recurrentgemma-9b", 3, {}, 96),
         "musicgen": ("musicgen-large", 2, {}, 40),
         "xlstm": ("xlstm-350m", 4, {}, 40)}
_RINGS = ("k", "v", "k_scale", "v_scale")


def _block(a: np.ndarray, spec, sizes, coords) -> np.ndarray:
    """The block of ``a`` a rank at mesh ``coords`` holds under ``spec``
    (a dim cut by one axis, or by a tuple of axes, major first)."""
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        if not axes:
            continue
        i = n = 0
        for ax in axes:
            i, n = (i * sizes[ax] + coords[ax], (n or 1) * sizes[ax])
        size = a.shape[dim] // n
        a = np.take(a, range(i * size, (i + 1) * size), axis=dim)
    return a


def _pool_spec(path, shape, sizes):
    """The reference's spec of a ring leaf; a recurrent state or ``pos``
    (the slot axis of the reference's pool) cut over "data" only."""
    name = path[-1]
    if name in _RINGS:
        return jsh._state_leaf_spec(path, shape, "data", sizes)
    spec = [None] * len(shape)
    if shape and shape[0] % sizes["data"] == 0:
        spec[0] = "data"
    return tuple(spec)


def _case(name, tmp_path):
    arch, layers, over, max_len = ARCHS[name]
    jcfg, tcfg = configs(num_layers=layers, arch=arch, **over)
    _, tparams = params_pair(jcfg, tcfg, seed=3)
    path = str(tmp_path / f"{name}.pt")
    torch.save(tparams, path)
    return tcfg, tparams, path, max_len


def test_each_rank_holds_its_blocks_and_their_bytes(tmp_path):
    """On each mesh, for every rank: every param leaf is its block of the
    reference's ``param_pspecs`` rule (the same path, shape and axis
    sizes), ``unplace_params`` gives the params back exactly, every
    leaf of a 4-slot dense pool is its block (a ring's positions over
    "model", slots over "data"), and the rank's placed bytes of the
    params and the rings equal ``launch.specs.argument_bytes`` under the
    specs the dry run uses."""
    cases, want = [], {}
    for name in ARCHS:
        tcfg, tparams, path, max_len = _case(name, tmp_path)
        for shape in MESHES:
            key = f"{name}_{shape[0]}x{shape[1]}"
            cases.append((key, tcfg, path, shape, SLOTS, max_len))
            want[key] = (tcfg, tparams, shape, max_len)
    run_ranks(placement_rank, 4, tmp_path, cases, str(tmp_path))
    for key, (tcfg, tparams, (D, M), max_len) in want.items():
        sizes = {"data": D, "model": M}
        mesh = specs.MeshShape(("data", "model"), (D, M))
        whole = _flat(tparams)
        pool = _flat(init_layer_states(tcfg, SLOTS, max_len,
                                       torch.device("cpu")))
        # the dry run's per-rank bytes of the params and the rings
        p_fake, p_spec = specs.param_specs(tcfg, mesh)
        states = init_layer_states(tcfg, SLOTS, max_len, torch.device("cpu"))
        s_spec = jsh.state_pspecs(
            {"flat": [{k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
                       for k, v in layer.items()} for layer in states]},
            mesh)["flat"]
        rings = [{k: v for k, v in layer.items() if k in _RINGS}
                 for layer in states]
        r_spec = [{k: tuple(v) for k, v in layer.items() if k in _RINGS}
                  for layer in s_spec]
        _, want_bytes = specs.argument_bytes((p_fake, rings),
                                             (p_spec, r_spec), mesh)
        for r in range(4):
            coords = {"data": r // M, "model": r % M}
            got = np.load(tmp_path / f"{key}.{r}.npz")
            assert bool(got["roundtrip"]), f"{key} rank {r}: round trip"
            held = 0
            for path, a in whole.items():
                spec = jsh._leaf_spec(tuple(path.split("/")), a.shape, sizes)
                block = got[f"p:{path}"]
                np.testing.assert_array_equal(
                    block, _block(a, spec, sizes, coords),
                    err_msg=f"{key} rank {r} {path} {spec}")
                held += block.nbytes
            for path, a in pool.items():
                spec = _pool_spec(tuple(path.split("/")), a.shape, sizes)
                block = got[f"s:{path}"]
                assert block.shape == _block(a, spec, sizes, coords).shape, \
                    f"{key} rank {r} {path} {spec}"
                if path.split("/")[-1] in _RINGS:
                    held += block.nbytes
            assert held == want_bytes, f"{key} rank {r}: {held} bytes " \
                                       f"placed, the dry run {want_bytes}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_split_and_merge_over_a_cut_ring_equal_the_whole_ring(dtype):
    """A 160-slot ring of 4 lanes cut into 4 slices of 40 as the "model"
    ranks hold it, the last slice empty for every lane and the third for
    some: the plain split pass over each slice's valid prefix
    (``ops.flash_decode_partials``), the partials concatenated as the
    all-gather gives them and the plain merge over all of them equal the
    whole ring's plain decode and the reference's oracle within 1e-6 (in
    f32 arithmetic; bf16 inputs, f32 outputs compared); a lane of length
    0 gives zeros, never NaN."""
    g = torch.Generator().manual_seed(7)
    B, H, KV, S, hd, M = 5, 16, 2, 160, 64, 4
    q = torch.randn((B, H, hd), generator=g).to(dtype)
    k = torch.randn((B, KV, S, hd), generator=g).to(dtype)
    v = torch.randn((B, KV, S, hd), generator=g).to(dtype)
    lens = torch.tensor([120, 81, 40, 1, 0], dtype=torch.int32)
    Wl = S // M
    per, n = decode_attention.split_plan(B, KV, Wl, decode_attention.TILE)
    parts = []
    for j in range(M):
        mine = torch.clamp(lens - j * Wl, 0, Wl).to(torch.int32)
        parts.append(ops.flash_decode_partials(
            q, k[:, :, j * Wl:(j + 1) * Wl].contiguous(),
            v[:, :, j * Wl:(j + 1) * Wl].contiguous(), mine))
        assert parts[-1][0].shape == (B, KV, n, H // KV, hd)
    assert torch.isinf(parts[-1][1]).all() and not parts[-1][2].any()
    acc, m, l = (torch.cat([p[i] for p in parts], 2) for i in range(3))
    out = ops.decode_merge(acc, m, l, torch.float32)
    live = lens > 0
    want = ref.decode_ref(q.float(), k.float(), v.float(), lens)
    assert float((out[live] - want[live]).abs().max()) <= 1e-6
    jwant = np.asarray(jref.decode_ref(
        jnp.asarray(q.float().numpy()), jnp.asarray(k.float().numpy()),
        jnp.asarray(v.float().numpy()), jnp.asarray(lens.numpy())))
    assert float(np.abs(out[live].numpy() - jwant[live.numpy()]).max()) \
        <= 1e-6
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    # one pass over the whole ring: the one-call plain decode's split plan
    acc1, m1, l1 = ops.flash_decode_partials(q, k, v, lens)
    one = ops.decode_merge(acc1, m1, l1, dtype)
    assert float((one[live].float() - ops.flash_decode(
        q, k, v, lens)[live].float()).abs().max()) <= (
            1e-6 if dtype == torch.float32 else 1e-2)


def test_plain_merge_of_empty_partials_is_zero_not_nan():
    """Every partial empty (m = -inf, l = 0, acc = 0): zeros."""
    acc = torch.zeros((2, 1, 3, 4, 16))
    m = torch.full((2, 1, 3, 4), -float("inf"))
    out = ops.decode_merge(acc, m, torch.zeros_like(m), torch.float32)
    assert torch.equal(out, torch.zeros((2, 4, 16)))
