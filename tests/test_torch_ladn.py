"""Port of the fused LADN chain: the plain version against the JAX Pallas
kernel (interpret mode) and the JAX oracle, stacked agents against
separate calls, ``ops.ladn_denoise`` against the reference's
``run_reverse_chain``, the ops dispatch and its no-gradient guard, the
kernel's launch plan and a plain mirror of its order of summation
(``_torch_ladn_sums.py``), and the CUDA kernel against its plain version
on a card.

Inputs are numpy arrays from a seed, fed to both packages; the chain's
noise is injected, so both run the same draws.  f32 throughout; the
tolerance 1e-5 covers summation order only.

The JAX package is imported inside the parity tests only, so that the
``cuda`` tests also collect on a GPU machine without JAX
(``pytest -m cuda tests/test_torch_ladn.py``).
"""
import numpy as np
import pytest
import torch

from _torch_ladn_sums import ladn_chain_split
from repro_torch.core import networks as nets
from repro_torch.core.diffusion import make_schedule_np
from repro_torch.kernels import ladn_denoise, ops, ref

TOL = 1e-5
CASES = [(64, 20, 22, 5), (128, 10, 12, 3), (32, 30, 42, 8)]  # T, A, S, I
# (G, T, I, A, S, H): the LAD-TS path's shapes (chip_smoke.py phase 5):
# acting, the update's K = 64 chains, one live placement, and a shape
# above 32 wide with a ragged last block
SHAPES = {"act": (20, 1, 5, 20, 22, 20), "update": (20, 64, 5, 20, 22, 20),
          "live": (1, 1, 3, 2, 4, 20), "wide": (4, 33, 7, 40, 70, 64)}
# the closed loop's (repro_torch.bench): 4 edges, the QoS observation
# S = 3 + 2 * 4, I = 3; acting and the update in the QoS simulator, one
# live placement
CLOSED_LOOP_SHAPES = {"cl_act": (4, 1, 3, 4, 11, 20),
                      "cl_update": (4, 64, 3, 4, 11, 20),
                      "cl_live": (1, 1, 3, 4, 11, 20)}
# the fault layer's (``serve --chaos``): 2 edges, the availability
# observation S = 2 + 2 * 2, I = 3; acting and the update in the
# fault-enabled simulator, one live placement
CHAOS_SHAPES = {"chaos_act": (2, 1, 3, 2, 6, 20),
                "chaos_update": (2, 64, 3, 2, 6, 20),
                "chaos_live": (1, 1, 3, 2, 6, 20)}
# the width class each shape takes on the card: the phase-5 shapes, and
# one shape for each class no phase-5 shape reaches
CUDA_WIDTHS = {"act": 24, "update": 24, "live": 24, "wide": 128,
               "cl_act": 24, "cl_update": 24, "cl_live": 24,
               "chaos_act": 24, "chaos_update": 24, "chaos_live": 24,
               "width32": 32, "width64": 64}
CUDA_SHAPES = {**SHAPES, **CLOSED_LOOP_SHAPES, **CHAOS_SHAPES,
               "width32": (3, 5, 4, 30, 32, 28),
               "width64": (2, 9, 5, 40, 60, 64)}


def _inputs(T, A, S, I, seed=0):  # noqa: E741
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, A)).astype(np.float32),
            rng.standard_normal((T, S)).astype(np.float32),
            rng.standard_normal((T, I, A)).astype(np.float32))


def _jax_theta(S, A, seed=0):
    import jax
    from repro.core import networks as jnets
    theta = jnets.init_ladn(jax.random.key(seed), S, A, (20, 20))
    return theta, jax.tree_util.tree_map(np.asarray, theta)


def _stack(theta_np, G=1):
    """Reference LADN params (numpy) -> the port's stacked tree."""
    return [{k: torch.from_numpy(np.stack([v] * G)) for k, v in layer.items()}
            for layer in theta_np]


def _port_chain(theta, x, s, noise, I):  # noqa: E741
    """The plain version on the port's packed layout, G = 1."""
    A, S = x.shape[-1], s.shape[-1]
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, S, A)
    temb_w1 = nets.timestep_embed(torch.arange(I, 0, -1)) @ w1t
    return ref.ladn_denoise_ref(
        torch.from_numpy(x)[None], torch.from_numpy(s)[None],
        torch.from_numpy(noise)[None], temb_w1, w1x, w1s, b1, w2, b2, w3,
        b3, make_schedule_np(I))[0]


@pytest.mark.parametrize("T,A,S,I", CASES)
def test_plain_chain_matches_pallas_interpret(T, A, S, I):  # noqa: E741
    import jax.numpy as jnp
    from repro.core import networks as jnets
    from repro.core.diffusion import make_schedule as jax_make_schedule
    from repro.kernels import ops as jops
    from repro.kernels.ladn_denoise import ladn_denoise_fused
    theta, theta_np = _jax_theta(S, A)
    x, s, noise = _inputs(T, A, S, I)
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = jops.pack_ladn_weights(theta, S, A,
                                                               20)
    temb_w1 = jops._pad_to(jnets.timestep_embed(jnp.arange(I, 0, -1)) @ w1t,
                           128, 1)
    want = ladn_denoise_fused(
        jops._pad_to(jnp.asarray(x), 128, 1),
        jops._pad_to(jnp.asarray(s), 128, 1),
        jops._pad_to(jnp.asarray(noise), 128, 2), temb_w1, w1x, w1s, b1, w2,
        b2, w3, b3, jax_make_schedule(I), bt=32, interpret=True)[:, :A]
    got = _port_chain(_stack(theta_np), x, s, noise, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("T,A,S,I", CASES)
def test_plain_chain_matches_jnp_oracle(T, A, S, I):  # noqa: E741
    import jax.numpy as jnp
    from repro.core import networks as jnets
    from repro.core.diffusion import make_schedule as jax_make_schedule
    from repro.kernels import ref as jref
    theta, theta_np = _jax_theta(S, A, seed=1)
    x, s, noise = _inputs(T, A, S, I, seed=1)
    w1 = theta[0]["w"]
    temb_w1 = jnets.timestep_embed(jnp.arange(I, 0, -1)) @ w1[A:A + 16]
    want = jref.ladn_denoise_ref(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(noise), temb_w1,
        w1[:A], w1[A + 16:], theta[0]["b"], theta[1]["w"], theta[1]["b"],
        theta[2]["w"], theta[2]["b"], jax_make_schedule(I))
    got = _port_chain(_stack(theta_np), x, s, noise, I)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_stacked_agents_equal_separate_calls():
    """G = 3 agents with their own weights in one call give exactly what
    three G = 1 calls give."""
    gen = torch.Generator().manual_seed(3)
    theta = nets.init_ladn(gen, 22, 20, (20, 20), num_agents=3)
    x = torch.randn((3, 7, 20), generator=gen)
    s = torch.randn((3, 7, 22), generator=gen)
    noise = torch.randn((3, 7, 5, 20), generator=gen)
    x0, probs = ops.ladn_denoise(theta, x, s, noise)
    for g in range(3):
        one = [{k: v[g:g + 1] for k, v in layer.items()} for layer in theta]
        x0_g, probs_g = ops.ladn_denoise(one, x[g:g + 1], s[g:g + 1],
                                         noise[g:g + 1])
        torch.testing.assert_close(x0[g:g + 1], x0_g, atol=1e-6, rtol=1e-6)
        torch.testing.assert_close(probs[g:g + 1], probs_g, atol=1e-6,
                                   rtol=1e-6)


@pytest.mark.parametrize("paper_variance", [True, False])
def test_ops_matches_reference_reverse_chain(paper_variance):
    """``ops.ladn_denoise`` is the agents' ``run_reverse_chain`` given the
    noise the reference draws from its key."""
    import jax
    from repro.core import networks as jnets
    from repro.core.diffusion import make_schedule as jax_make_schedule
    from repro.core.diffusion import run_reverse_chain
    S, A, I, T = 22, 20, 5, 16  # noqa: E741
    theta, theta_np = _jax_theta(S, A, seed=2)
    x, s, _ = _inputs(T, A, S, I, seed=2)
    key = jax.random.key(5)
    x0_j, probs_j = run_reverse_chain(
        jax_make_schedule(I), lambda xx, i, ss: jnets.apply_ladn(theta, xx,
                                                                 i, ss),
        x, s, key, paper_variance)
    noise = np.asarray(jax.random.normal(key, (I, T, A)))
    x0, probs = ops.ladn_denoise(
        _stack(theta_np), torch.from_numpy(x)[None],
        torch.from_numpy(s)[None],
        torch.from_numpy(noise.transpose(1, 0, 2).copy())[None],
        num_steps=I, paper_variance=paper_variance)
    np.testing.assert_allclose(x0[0].numpy(), np.asarray(x0_j), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(probs[0].numpy(), np.asarray(probs_j),
                               atol=TOL, rtol=TOL)


def _small_case(G=2, T=4, A=6, S=5, I=3, seed=4):  # noqa: E741
    gen = torch.Generator().manual_seed(seed)
    theta = nets.init_ladn(gen, S, A, (8, 8), num_agents=G)
    return (theta, torch.randn((G, T, A), generator=gen),
            torch.randn((G, T, S), generator=gen),
            torch.randn((G, T, I, A), generator=gen))


def test_ops_dispatches_cpu_tensors_to_plain_version():
    """A CPU tensor goes to the plain version and is not counted as a
    kernel launch."""
    theta, x, s, noise = _small_case()
    before = ops.launches["ladn_denoise"]
    x0, _ = ops.ladn_denoise(theta, x, s, noise, num_steps=3)
    assert ops.launches["ladn_denoise"] == before
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, 5, 6)
    temb_w1 = nets.timestep_embed(torch.arange(3, 0, -1)) @ w1t
    want = ref.ladn_denoise_ref(x, s, noise, temb_w1, w1x, w1s, b1, w2, b2,
                                w3, b3, make_schedule_np(3))
    torch.testing.assert_close(x0, want, atol=0.0, rtol=0.0)


def test_ops_refuses_a_gradient_it_cannot_give():
    """Weights that need a gradient are refused while grad mode is on
    (the kernel has no backward); without grad mode they are served."""
    theta, x, s, noise = _small_case()
    theta[1]["w"].requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ladn_denoise(theta, x, s, noise, num_steps=3)
    with torch.no_grad():
        x0, _ = ops.ladn_denoise(theta, x, s, noise, num_steps=3)
    assert x0.shape == x.shape and not x0.requires_grad


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The kernel entry never serves a CPU tensor (no fallback) and
    checks the step count and widths before it launches."""
    theta, x, s, noise = _small_case()
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, 5, 6)
    temb_w1 = nets.timestep_embed(torch.arange(3, 0, -1)) @ w1t
    args = (x, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3)
    with pytest.raises(ValueError, match="CUDA"):
        ladn_denoise.ladn_denoise_fused(*args, make_schedule_np(3))
    with pytest.raises(ValueError, match="steps"):
        ladn_denoise.ladn_denoise_fused(*args, make_schedule_np(17))


def test_step_constants_fold_the_schedule():
    """Per step (c0, c1, c2) = (lambda^-1/2, beta / sqrt(1 - lbar), noise
    scale), no noise at i = 1, in the chain's order i = I..1."""
    sched = make_schedule_np(4)
    consts = ladn_denoise.step_consts(sched, paper_variance=True)
    for step, (c0, c1, c2) in enumerate(consts):
        idx = 3 - step
        assert c0 == pytest.approx(float(sched.lambdas[idx]) ** -0.5)
        assert c1 == pytest.approx(float(sched.betas[idx])
                                   / (1 - float(sched.lambda_bars[idx]))
                                   ** 0.5)
        want = 0.0 if idx == 0 else float(sched.beta_tildes[idx]) / 2
        assert c2 == pytest.approx(want)
    ddpm = ladn_denoise.step_consts(sched, paper_variance=False)
    assert ddpm[0][2] == pytest.approx(float(sched.beta_tildes[3]) ** 0.5)


@pytest.mark.parametrize("name,width", [("act", 24), ("update", 24),
                                        ("live", 24), ("wide", 128)])
def test_plan_picks_the_width_class(name, width):
    """The three main-path shapes take the register kernel (the <= 32
    classes: no shared memory, one warp a block) at width 24, their widest
    width being 22 or 20; the shape above 32 wide takes the shared-memory
    kernel of the next width class, 4 rows a block."""
    G, T, I, A, S, H = SHAPES[name]  # noqa: E741
    plan = ladn_denoise.plan(G, T, A, S, H, I)
    assert plan.width == width
    if width <= 32:
        assert (plan.rows, plan.smem) == (1, 0)
        assert plan.kernel == "ladn_regs_kernel<24>"
    else:
        assert plan.rows == 4 and plan.kernel == "ladn_smem_kernel<128>"
        # w1x 64 x 64, w2 64 x 64, w3 64 x 64 (A padded to 64), 7 time
        # rows of 64 and the biases
        assert plan.smem == 4 * (3 * 64 * 64 + 7 * 64 + 2 * 64 + 64)
    assert plan.threads == 32 * plan.rows and plan.agents == G
    for widths, want in (((2, 4, 8), 24), ((9, 4, 8), 24), ((24, 2, 2), 24),
                         ((25, 2, 2), 32), ((20, 32, 8), 32),
                         ((40, 60, 64), 64), ((33, 2, 2), 64),
                         ((2, 65, 2), 128)):
        assert ladn_denoise.plan(4, 33, *widths, 7).width == want


def test_plan_refuses_what_the_kernel_does_not_take():
    plan = ladn_denoise.plan
    for args, match in (((1, 1, 129, 4, 20, 5), "widths"),
                        ((1, 1, 2, 4, 129, 5), "widths"),
                        ((1, 1, 2, 0, 20, 5), "widths"),
                        ((1, 1, 2, 4, 20, 17), "steps"),
                        ((1, 1, 2, 4, 20, 0), "steps"),
                        ((65536, 1, 2, 4, 20, 5), "agents"),
                        ((0, 1, 2, 4, 20, 5), "agents"),
                        ((1, 0, 2, 4, 20, 5), "rows")):
        with pytest.raises(ValueError, match=match):
            plan(*args)
    # the largest shape fits a block's shared memory
    assert ladn_denoise.plan(1, 1, 128, 128, 128, 16).smem <= \
        ladn_denoise.MAX_SMEM


@pytest.mark.parametrize("T", [1, 33, 64])
@pytest.mark.parametrize("A,S,H", [(20, 22, 20), (40, 60, 64),
                                   (40, 70, 64)])
def test_plan_grid_covers_every_row(T, A, S, H):
    """Warp w of row tile b takes row b * rows + w: every row once, and
    only the last tile has warps past T."""
    plan = ladn_denoise.plan(3, T, A, S, H, 5)
    assert plan.grid == (plan.blocks, 3)
    taken = [b * plan.rows + w for b in range(plan.blocks)
             for w in range(plan.rows)]
    assert [r for r in taken if r < T] == list(range(T))
    assert all(r >= (plan.blocks - 1) * plan.rows for r in taken if r >= T)


@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_split_sums_stay_close_to_plain_version(name):
    """The kernel's four partial sums (k % 4) change the order of every
    product's sum; at each shape the card is tested at that stays within
    1e-5 of the plain version's k order."""
    G, T, I, A, S, H = CUDA_SHAPES[name]  # noqa: E741
    gen = torch.Generator().manual_seed(11)
    theta = nets.init_ladn(gen, S, A, (H, H), num_agents=G)
    rng = np.random.default_rng(11)
    x, s, noise = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32))
                   for shape in ((G, T, A), (G, T, S), (G, T, I, A)))
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, S, A)
    temb_w1 = nets.timestep_embed(torch.arange(I, 0, -1)) @ w1t
    args = (x, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
            make_schedule_np(I))
    want = ref.ladn_denoise_ref(*args)
    got = ladn_chain_split(*args)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_cuda_kernel_matches_plain_version(name):
    """At each phase-5 shape and at one shape of each width class they do
    not reach, through ``ops.ladn_denoise``'s views of the stacked first
    layer and on packed copies alike; a CUDA-graph replay gives the eager
    call's bits; the C entry's shared memory is the plan's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    G, T, I, A, S, H = CUDA_SHAPES[name]  # noqa: E741
    assert ladn_denoise.plan(G, T, A, S, H, I).width == CUDA_WIDTHS[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    theta = nets.init_ladn(gen, S, A, (H, H), num_agents=G, device=dev)
    x = torch.randn((G, T, A), generator=gen, device=dev)
    s = torch.randn((G, T, S), generator=gen, device=dev)
    noise = torch.randn((G, T, I, A), generator=gen, device=dev)
    w1x, w1t, w1s, b1, w2, b2, w3, b3 = ops.pack_ladn_weights(theta, S, A)
    temb_w1 = nets.timestep_embed(torch.arange(I, 0, -1, device=dev),
                                  device=dev) @ w1t
    args = (x, s, noise, temb_w1, w1x, w1s, b1, w2, b2, w3, b3,
            make_schedule_np(I))
    got = ladn_denoise.ladn_denoise_fused(*args)
    torch.cuda.synchronize()
    want = ref.ladn_denoise_ref(*args)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    before = ops.launches["ladn_denoise"]
    x0, _ = ops.ladn_denoise(theta, x, s, noise, num_steps=I)
    assert ops.launches["ladn_denoise"] == before + 1
    torch.testing.assert_close(x0, want, atol=1e-4, rtol=1e-4)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ladn_denoise.ladn_denoise_fused(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ladn_denoise.ladn_denoise_fused(*args)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)

    plan = ladn_denoise.plan(G, T, A, S, H, I)
    lib = ladn_denoise._library()
    assert lib.repro_ladn_denoise_smem_bytes(plan.width, A, H, I) == \
        plan.smem


@pytest.mark.cuda
def test_cuda_noop_launches():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    ladn_denoise.noop()
    torch.cuda.synchronize()
