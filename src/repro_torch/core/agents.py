"""Scheduling agents: LAD-TS (the paper), D2SAC-TS, SAC-TS and DQN-TS.

Port of ``repro/core/agents.py``.  The reference keeps one agent per
NamedTuple and vmaps B of them; here each state holds the B agents stacked
(every leaf has the agent axis G in front) and one call acts or updates
for all of them.  Field names and parameter trees are the reference's, so
``repro_torch.convert.agent_states_from_jax`` carries a state across.

Randomness is explicit.  Every draw (the chain's start noise ``eps0``, the
reverse chain's noise, the Gumbel noise of the categorical sample, the
replay indices, DQN's epsilon draw) is an argument; the trainer draws them
from a ``torch.Generator`` (``draw_chain_noise``, ``gumbel``), and the
parity tests pass in the reference's own draws.

LAD-TS (paper §IV): the actor is the LADN reverse chain conditioned on the
state and started from the latent action X_b[n] (the last standardized
x_0 for the same task slot); critics, targets and the entropy temperature
follow discrete soft actor-critic (Eqns 14-17); the acting copy theta~ is
refreshed after every update (Algorithm 1 line 18).  D2SAC-TS is LAD-TS
with ``latent_init=False``.

Where no gradient is needed — acting, the target term ``probs_next`` and
the entropy term ``probs_now`` — the chain runs through the fused kernel
(``kernels.ops.ladn_denoise``).  The actor loss differentiates through the
chain, so it runs the plain, autograd-traceable chain.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core import networks as nets
from repro_torch.core.diffusion import (DiffusionPolicyConfig, make_schedule,
                                        run_reverse_chain)
from repro_torch.core.optim import (AdamState, adam_init, adam_update,
                                    tree_leaves, tree_map)
from repro_torch.core.replay import (ReplayState, replay_add, replay_init,
                                     replay_sample)
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Model hyper-parameters (paper Table IV)."""

    hidden: Tuple[int, ...] = (20, 20)
    lr_actor: float = 1e-4
    lr_critic: float = 1e-3
    lr_alpha: float = 3e-4
    gamma: float = 0.95
    tau: float = 0.005
    batch_size: int = 64
    replay_capacity: int = 1000
    train_after: int = 300          # |R| > 300 before updates (Alg. 1)
    init_alpha: float = 0.05
    target_entropy: float = -1.0
    # rewards are -delay (seconds); the scale conditions critic targets
    reward_scale: float = 0.1
    diffusion: DiffusionPolicyConfig = DiffusionPolicyConfig()
    # DQN-only
    eps_start: float = 0.9
    eps_end: float = 0.05
    eps_decay_steps: int = 2000


class Transition(NamedTuple):
    s: torch.Tensor
    x: torch.Tensor        # latent action x_I used for this decision
    a: torch.Tensor        # () int64
    r: torch.Tensor        # () f32
    s_next: torch.Tensor
    x_next: torch.Tensor


def transition_spec(state_dim: int, action_dim: int) -> Transition:
    """One item's shapes and dtypes, as zero tensors."""
    f = torch.zeros
    return Transition(s=f((state_dim,)), x=f((action_dim,)),
                      a=torch.zeros((), dtype=torch.int64), r=f(()),
                      s_next=f((state_dim,)), x_next=f((action_dim,)))


class ChainNoise(NamedTuple):
    """Draws of one batch of policy chains: ``eps0`` (G, T, A) noises the
    latent to level I (or is x_I itself without ``latent_init``);
    ``chain`` (G, T, I, A) is the reverse chain's noise, ``chain[:, :,
    step]`` at i = I - step."""

    eps0: torch.Tensor
    chain: torch.Tensor


def draw_chain_noise(G: int, T: int, A: int, num_steps: int,
                     generator: torch.Generator) -> ChainNoise:
    dev = generator.device
    return ChainNoise(
        eps0=torch.randn((G, T, A), generator=generator, device=dev),
        chain=torch.randn((G, T, num_steps, A), generator=generator,
                          device=dev))


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise: ``argmax(logits + gumbel)`` is a categorical
    sample, as ``jax.random.categorical`` draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def _value_and_grad(loss_fn: Callable, params) -> Tuple[torch.Tensor, Any]:
    """Per-agent losses (G,) and the gradient of each agent's loss with
    respect to its own parameters (agents share no parameters, so one
    backward of the sum gives every agent's gradient)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss.sum(), leaves)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def _soft(target, online, tau: float):
    return tree_map(lambda a, b: (1 - tau) * a + tau * b, target, online)


def _log_clip(probs: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(probs, min=1e-8))


# ===========================================================================
# LAD-TS (and D2SAC-TS via cfg.diffusion.latent_init=False)
# ===========================================================================


class LadtsState(NamedTuple):
    theta: Any            # t-LADN (trained)
    theta_act: Any        # s-LADN (acting copy)
    c1: Any
    c2: Any
    t1: Any
    t2: Any
    log_alpha: torch.Tensor   # (G,)
    opt_theta: AdamState
    opt_c1: AdamState
    opt_c2: AdamState
    opt_alpha: AdamState
    X: torch.Tensor       # (G, N_max, A) latent action store
    replay: ReplayState
    steps: torch.Tensor   # (G,)


def _copy(tree):
    return tree_map(torch.clone, tree)


def ladts_init(generator: torch.Generator, cfg: AgentConfig, state_dim: int,
               action_dim: int, n_max: int, num_agents: int) -> LadtsState:
    G, dev = num_agents, generator.device
    theta = nets.init_ladn(generator, state_dim, action_dim, cfg.hidden, G,
                           dev)
    c1 = nets.init_critic(generator, state_dim, action_dim, cfg.hidden, G,
                          dev)
    c2 = nets.init_critic(generator, state_dim, action_dim, cfg.hidden, G,
                          dev)
    X = torch.randn((G, n_max, action_dim), generator=generator, device=dev)
    spec = tree_map(lambda t: t.to(dev),
                    transition_spec(state_dim, action_dim))
    return LadtsState(
        theta=theta, theta_act=_copy(theta), c1=c1, c2=c2,
        t1=_copy(c1), t2=_copy(c2),
        log_alpha=torch.full((G,), math.log(cfg.init_alpha), device=dev),
        opt_theta=adam_init(theta), opt_c1=adam_init(c1),
        opt_c2=adam_init(c2),
        opt_alpha=adam_init(torch.zeros((G,), device=dev)),
        X=X, replay=replay_init(cfg.replay_capacity, spec, G, dev),
        steps=torch.zeros((G,), dtype=torch.int64, device=dev))


@functools.lru_cache(maxsize=None)
def _schedule(dcfg: DiffusionPolicyConfig, device: torch.device):
    """The chain's schedule on ``device`` and the f32 factors of Eqn 11 at
    level I, made once per configuration and device."""
    sched = make_schedule(dcfg.num_steps, dcfg.beta_min, dcfg.beta_max)
    lbar = sched.lambda_bars[-1]
    return (type(sched)(*(t.to(device) for t in sched)),
            float(torch.sqrt(lbar)), float(torch.sqrt(1 - lbar)))


def _policy_probs(theta, cfg: AgentConfig, s: torch.Tensor,
                  x_latent: torch.Tensor, noise: ChainNoise, fused: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pi(.|s, latent): reverse chain + softmax, for G agents' rows.

    s (G, T, S) and the RAW stored latent x_latent (G, T, A) (ignored
    without ``latent_init``).  The forward noising to level I (Eqn 11)
    happens here, so acting and training evaluate the policy alike:
    x_I = sqrt(lbar_I) latent + sqrt(1 - lbar_I) eps0.  ``fused`` runs the
    chain through ``ops.ladn_denoise`` (no gradient); otherwise through
    the plain chain, which autograd can differentiate.
    Returns (x0, probs), both (G, T, A)."""
    dcfg = cfg.diffusion
    sched, sq_lbar, sq_1m_lbar = _schedule(dcfg, s.device)
    if dcfg.latent_init:
        x_I = sq_lbar * x_latent + sq_1m_lbar * noise.eps0
    else:
        x_I = noise.eps0                    # D2SAC: pure Gaussian start
    if fused:
        return ops.ladn_denoise(theta, x_I, s, noise.chain,
                                num_steps=dcfg.num_steps,
                                beta_min=dcfg.beta_min,
                                beta_max=dcfg.beta_max,
                                paper_variance=dcfg.paper_variance)
    return run_reverse_chain(
        sched, lambda x, i, ss: nets.apply_ladn(theta, x, i, ss), x_I, s,
        noise=noise.chain.movedim(2, 0),
        paper_variance=dcfg.paper_variance)


def ladts_act(state: LadtsState, cfg: AgentConfig, s: torch.Tensor, n: int,
              noise: ChainNoise, gumbel_noise: torch.Tensor,
              greedy: bool = False) -> Tuple[torch.Tensor, LadtsState]:
    """One decision per agent for task slot ``n``: s (G, S) -> (G,) int64.

    ``noise`` holds one row per agent ((G, 1, ...)); ``gumbel_noise``
    (G, A).  Actions are sampled from pi; ``greedy`` takes Eqn (8)'s
    argmax of pi instead (the draws are still taken, so a generator's
    stream does not depend on it).  The latent store keeps the
    standardized x_0 (population std, as ``jnp.std``) either way."""
    x0, probs = _policy_probs(state.theta_act, cfg, s[:, None],
                              state.X[:, n][:, None], noise, fused=True)
    x0, probs = x0[:, 0], probs[:, 0]
    if greedy:
        a = torch.argmax(probs, dim=-1)
    else:
        a = torch.argmax(_log_clip(probs) + gumbel_noise, dim=-1)
    x0n = (x0 - x0.mean(-1, keepdim=True)) / (
        x0.std(-1, keepdim=True, correction=0) + 1e-6)
    X = state.X.clone()
    X[:, n] = x0n
    return a, state._replace(X=X)


def ladts_update(state: LadtsState, cfg: AgentConfig, idx: torch.Tensor,
                 next_noise: ChainNoise, actor_noise: ChainNoise,
                 now_noise: ChainNoise) -> Tuple[LadtsState, dict]:
    """One SAC update per agent on ``idx`` (G, K) replay rows, with the
    draws of the three policy evaluations (each (G, K, ...))."""
    batch: Transition = replay_sample(state.replay, idx.shape[1], idx=idx)
    alpha = torch.exp(state.log_alpha)[:, None]          # (G, 1)

    # --- target Q (discrete soft expectation form) -------------------------
    _, probs_next = _policy_probs(state.theta, cfg, batch.s_next,
                                  batch.x_next, next_noise, fused=True)
    logp_next = _log_clip(probs_next)
    qn = torch.minimum(nets.apply_critic(state.t1, batch.s_next),
                       nets.apply_critic(state.t2, batch.s_next))
    h_next = -(probs_next * logp_next).sum(-1)
    v_next = (probs_next * qn).sum(-1) + alpha * h_next
    q_target = (batch.r + cfg.gamma * v_next).detach()    # (G, K)

    # --- critic update (Eqn 14) --------------------------------------------
    def critic_loss(cp):
        q = nets.apply_critic(cp, batch.s)
        qa = torch.gather(q, -1, batch.a[..., None])[..., 0]
        return ((qa - q_target) ** 2).mean(-1)

    lc1, g1 = _value_and_grad(critic_loss, state.c1)
    lc2, g2 = _value_and_grad(critic_loss, state.c2)
    c1, opt_c1 = adam_update(state.c1, g1, state.opt_c1, cfg.lr_critic)
    c2, opt_c2 = adam_update(state.c2, g2, state.opt_c2, cfg.lr_critic)

    # --- actor update (Eqn 15, standard discrete-SAC form) ------------------
    q_eval = torch.minimum(nets.apply_critic(c1, batch.s),
                           nets.apply_critic(c2, batch.s)).detach()

    def actor_loss(th):
        _, probs = _policy_probs(th, cfg, batch.s, batch.x, actor_noise,
                                 fused=False)
        return (probs * (alpha[..., None] * _log_clip(probs)
                         - q_eval)).sum(-1).mean(-1)

    la, gth = _value_and_grad(actor_loss, state.theta)
    theta, opt_theta = adam_update(state.theta, gth, state.opt_theta,
                                   cfg.lr_actor)

    # --- temperature update (Eqn 16) ----------------------------------------
    _, probs_now = _policy_probs(theta, cfg, batch.s, batch.x, now_noise,
                                 fused=True)
    h_now = -(probs_now * _log_clip(probs_now)).sum(-1).mean(-1)   # (G,)
    # d/d(log a) of exp(log a) * (h_now - target)
    ga = torch.exp(state.log_alpha) * (h_now - cfg.target_entropy)
    log_alpha, opt_alpha = adam_update(state.log_alpha, ga,
                                       state.opt_alpha, cfg.lr_alpha)

    # --- soft target update (Eqn 17) + s-LADN refresh ----------------------
    new = state._replace(
        theta=theta, theta_act=theta, c1=c1, c2=c2,
        t1=_soft(state.t1, c1, cfg.tau), t2=_soft(state.t2, c2, cfg.tau),
        log_alpha=log_alpha, opt_theta=opt_theta, opt_c1=opt_c1,
        opt_c2=opt_c2, opt_alpha=opt_alpha, steps=state.steps + 1)
    metrics = {"critic_loss": (lc1 + lc2) / 2, "actor_loss": la,
               "alpha": torch.exp(log_alpha), "entropy": h_now}
    return new, metrics


# ===========================================================================
# SAC-TS baseline: categorical MLP actor, same critic machinery
# ===========================================================================


class SacState(NamedTuple):
    actor: Any
    c1: Any
    c2: Any
    t1: Any
    t2: Any
    log_alpha: torch.Tensor
    opt_actor: AdamState
    opt_c1: AdamState
    opt_c2: AdamState
    opt_alpha: AdamState
    replay: ReplayState
    steps: torch.Tensor


def sac_init(generator: torch.Generator, cfg: AgentConfig, state_dim: int,
             action_dim: int, n_max: int, num_agents: int) -> SacState:
    G, dev = num_agents, generator.device
    actor = nets.init_mlp(generator, (state_dim, *cfg.hidden, action_dim),
                          G, dev)
    c1 = nets.init_critic(generator, state_dim, action_dim, cfg.hidden, G,
                          dev)
    c2 = nets.init_critic(generator, state_dim, action_dim, cfg.hidden, G,
                          dev)
    spec = tree_map(lambda t: t.to(dev),
                    transition_spec(state_dim, action_dim))
    return SacState(
        actor=actor, c1=c1, c2=c2, t1=_copy(c1), t2=_copy(c2),
        log_alpha=torch.full((G,), math.log(cfg.init_alpha), device=dev),
        opt_actor=adam_init(actor), opt_c1=adam_init(c1),
        opt_c2=adam_init(c2),
        opt_alpha=adam_init(torch.zeros((G,), device=dev)),
        replay=replay_init(cfg.replay_capacity, spec, G, dev),
        steps=torch.zeros((G,), dtype=torch.int64, device=dev))


def sac_act(state: SacState, cfg: AgentConfig, s: torch.Tensor,
            gumbel_noise: torch.Tensor, greedy: bool = False
            ) -> torch.Tensor:
    """A sample of the categorical actor (``gumbel_noise`` (G, A)), or
    its argmax when ``greedy``."""
    logits = nets.apply_mlp(state.actor, s)
    if greedy:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits + gumbel_noise, dim=-1)


def sac_update(state: SacState, cfg: AgentConfig, idx: torch.Tensor
               ) -> Tuple[SacState, dict]:
    batch: Transition = replay_sample(state.replay, idx.shape[1], idx=idx)
    alpha = torch.exp(state.log_alpha)[:, None]

    probs_next = torch.softmax(nets.apply_mlp(state.actor, batch.s_next), -1)
    logp_next = _log_clip(probs_next)
    qn = torch.minimum(nets.apply_critic(state.t1, batch.s_next),
                       nets.apply_critic(state.t2, batch.s_next))
    v_next = (probs_next * (qn - alpha[..., None] * logp_next)).sum(-1)
    q_target = (batch.r + cfg.gamma * v_next).detach()

    def critic_loss(cp):
        qa = torch.gather(nets.apply_critic(cp, batch.s), -1,
                          batch.a[..., None])[..., 0]
        return ((qa - q_target) ** 2).mean(-1)

    lc1, g1 = _value_and_grad(critic_loss, state.c1)
    lc2, g2 = _value_and_grad(critic_loss, state.c2)
    c1, opt_c1 = adam_update(state.c1, g1, state.opt_c1, cfg.lr_critic)
    c2, opt_c2 = adam_update(state.c2, g2, state.opt_c2, cfg.lr_critic)

    q_eval = torch.minimum(nets.apply_critic(c1, batch.s),
                           nets.apply_critic(c2, batch.s)).detach()

    def actor_loss(ap):
        probs = torch.softmax(nets.apply_mlp(ap, batch.s), -1)
        return (probs * (alpha[..., None] * _log_clip(probs)
                         - q_eval)).sum(-1).mean(-1)

    la, ga_ = _value_and_grad(actor_loss, state.actor)
    actor, opt_actor = adam_update(state.actor, ga_, state.opt_actor,
                                   cfg.lr_actor)

    probs_now = torch.softmax(nets.apply_mlp(actor, batch.s), -1)
    h_now = -(probs_now * _log_clip(probs_now)).sum(-1).mean(-1)
    gal = torch.exp(state.log_alpha) * (h_now - cfg.target_entropy)
    log_alpha, opt_alpha = adam_update(state.log_alpha, gal,
                                       state.opt_alpha, cfg.lr_alpha)

    new = state._replace(actor=actor, c1=c1, c2=c2,
                         t1=_soft(state.t1, c1, cfg.tau),
                         t2=_soft(state.t2, c2, cfg.tau),
                         log_alpha=log_alpha, opt_actor=opt_actor,
                         opt_c1=opt_c1, opt_c2=opt_c2, opt_alpha=opt_alpha,
                         steps=state.steps + 1)
    return new, {"critic_loss": (lc1 + lc2) / 2, "actor_loss": la,
                 "alpha": torch.exp(log_alpha), "entropy": h_now}


# ===========================================================================
# DQN-TS baseline
# ===========================================================================


class DqnState(NamedTuple):
    q: Any
    q_target: Any
    opt: AdamState
    replay: ReplayState
    steps: torch.Tensor


def dqn_init(generator: torch.Generator, cfg: AgentConfig, state_dim: int,
             action_dim: int, n_max: int, num_agents: int) -> DqnState:
    G, dev = num_agents, generator.device
    q = nets.init_critic(generator, state_dim, action_dim, cfg.hidden, G,
                         dev)
    spec = tree_map(lambda t: t.to(dev),
                    transition_spec(state_dim, action_dim))
    return DqnState(q=q, q_target=_copy(q), opt=adam_init(q),
                    replay=replay_init(cfg.replay_capacity, spec, G, dev),
                    steps=torch.zeros((G,), dtype=torch.int64, device=dev))


def dqn_act(state: DqnState, cfg: AgentConfig, s: torch.Tensor,
            rand_a: torch.Tensor, u: torch.Tensor, greedy: bool = False
            ) -> torch.Tensor:
    """Epsilon-greedy: ``rand_a`` (G,) uniform actions and ``u`` (G,)
    uniforms on [0, 1) decide exploration; ``greedy`` sets epsilon to 0."""
    best = torch.argmax(nets.apply_critic(state.q, s), dim=-1)
    if greedy:
        return best
    eps = cfg.eps_end + (cfg.eps_start - cfg.eps_end) * torch.exp(
        -state.steps.to(torch.float32) / cfg.eps_decay_steps)
    return torch.where(u < eps, rand_a, best)


def dqn_update(state: DqnState, cfg: AgentConfig, idx: torch.Tensor
               ) -> Tuple[DqnState, dict]:
    batch: Transition = replay_sample(state.replay, idx.shape[1], idx=idx)
    qn = nets.apply_critic(state.q_target, batch.s_next).amax(-1)
    tgt = (batch.r + cfg.gamma * qn).detach()

    def loss(qp):
        qa = torch.gather(nets.apply_critic(qp, batch.s), -1,
                          batch.a[..., None])[..., 0]
        return ((qa - tgt) ** 2).mean(-1)

    lv, g = _value_and_grad(loss, state.q)
    q, opt = adam_update(state.q, g, state.opt, cfg.lr_critic)
    return state._replace(q=q, q_target=_soft(state.q_target, q, cfg.tau),
                          opt=opt, steps=state.steps + 1), {
                              "critic_loss": lv}


def add_replay(state, item: Transition, valid: torch.Tensor):
    """Append each agent's transition where ``valid`` (G,) is set."""
    return state._replace(replay=replay_add(state.replay, item, valid))

