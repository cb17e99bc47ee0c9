"""Stratified MCMC (SMCMC, Gruson et al.) — one chain per pixel tile with
neighbor replica exchange.

Reference: src/integrators/mcmc/smcmc.rs. Each pixel owns a chain whose state
is a PSS vector evaluated over the 5-pixel cross centered there
(generate_state replays the same sequence at each cross pixel,
smcmc.rs:123-139). The schedule alternates
  MCMC / Horizontal(0) / MCMC / Vertical(0) / MCMC / Horizontal(1) / MCMC / Vertical(1)
where exchange steps swap PSS states between even/odd neighbor pairs and
accept jointly with min(1, tf0'·tf1'/(tf0·tf1)) (smcmc.rs:224-313) — the
halo-exchange pattern P4 in SURVEY.md §2.10, realized as pairwise swaps of
lane arrays (ppermute when sharded). Uninitialized chains bootstrap
with forced large steps (chain_non_init); the SMCMC mutator resamples the
pixel-jitter dims uniformly and Kelemen-mutates the rest (smcmc.rs:9-35).

Reconstruction: 'naive' overlap averaging (smcmc.rs:318-358) or the IRLS
overlap-consistency solver (smcmc.rs:359-904). Initialization: 'independent'
(nb_spp uniform attempts per tile, IndependentInit smcmc.rs:916-972) or
'mcmc' (image-space roaming chains seeded from a flux CDF that deposit their
states into visited tiles reservoir-style, MCMCInit smcmc.rs:974-1172 —
vectorized here as nb_chains parallel lanes with scatter-based reservoir
updates and batch-equivalent replacement probabilities).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ...samplers.pss import kelemen_mutate
from ...utils.film import Film
from ...utils.rng import make_stream, stream_fold, ArrayStream
from .pssmlt import _uniform

# cross offsets; slot 0 is the tile center (reference Tile::pixels)
_CROSS = [(0, 0), (-1, 0), (0, -1), (1, 0), (0, 1)]


class IntegratorSMCMC:
    averaging = True

    def __init__(self, integrator, large_prob: float = 0.3,
                 recons: str = "naive", pss_dims: Optional[int] = None,
                 init: str = "independent", init_spp: int = 4,
                 init_chain_length: int = 25, init_spp_mcmc: int = 2,
                 keep_chains: bool = False):
        assert init in ("independent", "mcmc")
        self.integrator = integrator
        self.large_prob = large_prob
        self.recons = recons
        self.init = init
        self.init_spp = init_spp
        self.init_chain_length = init_chain_length
        self.init_spp_mcmc = init_spp_mcmc
        # keep_chains: carry the FULL chain carry (states + accumulators)
        # across render() calls — the reference persists self.chains between
        # averaging passes (smcmc.rs:1174-1212): init/burn-in happens once,
        # later passes continue, and each pass returns the CUMULATIVE
        # reconstruction, so averaging() is false and avg-mode REPLACES
        # (smcmc.rs:1187-1191). Off by default so independent renders stay
        # independent; the CLI enables it under -a.
        self.keep_chains = keep_chains
        self.averaging = not keep_chains
        self._chain_state = None          # (scene id, carry pytree)
        # capture_hlo=True stashes the compiled HLO text of the PRODUCTION
        # sharded evolve step in self.last_hlo on the next render() — the
        # dryrun and P4 tests assert `collective-permute` on the real
        # lowering, not on a synthetic stand-in roll.
        self.capture_hlo = False
        self.last_hlo = None
        cap = getattr(integrator, "hard_cap", 16)
        self.pss_dims = pss_dims or (2 + 6 * cap)

    # ---- chain-state checkpointing (beyond-reference: the reference keeps
    # self.chains only in-process, smcmc.rs:1174-1212 — a crashed -a run
    # loses all chain history). The carry is a flat tuple of arrays; dumped
    # as-is it reproduces an uninterrupted run bit-exactly because pass
    # streams are derived from seed + pass index, not from carried RNG.

    def state_dict(self):
        """Serializable chain state, or None if no chains are held."""
        if self._chain_state is None:
            return None
        import numpy as _np
        _, carry = self._chain_state
        leaves = jax.tree.leaves(carry)
        d = {f"leaf_{i}": _np.asarray(x) for i, x in enumerate(leaves)}
        d["n_leaves"] = _np.asarray(len(leaves))
        d["pss_dims"] = _np.asarray(self.pss_dims)
        return d

    def load_state_dict(self, d, scene):
        """Bind a dumped chain state to `scene` for the next render()."""
        n_leaves = int(d["n_leaves"])
        if int(d["pss_dims"]) != self.pss_dims:
            raise ValueError(
                "SMCMC state mismatch: dumped pss_dims "
                f"{int(d['pss_dims'])} != configured {self.pss_dims}")
        carry = tuple(jnp.asarray(d[f"leaf_{i}"]) for i in range(n_leaves))
        n = scene.camera.width * scene.camera.height
        if carry[0].shape[0] != n:
            raise ValueError(
                f"SMCMC state mismatch: {carry[0].shape[0]} tile-chains "
                f"dumped, scene has {n} pixels")
        self._chain_state = (scene, carry)

    def render(self, scene, spp: int, seed: int = 0, verbose: bool = False,
               mesh=None) -> Film:
        """`mesh` (1-axis Mesh over 'd'): the per-pixel tile-chain arrays are
        device-split along the lane (pixel-row) axis via sharding
        constraints; the roll-based neighbor exchange then compiles to
        collective-permutes of the boundary rows (reference
        per-scanline chunks + even/odd exchange, smcmc.rs:1248-1327).
        Semantics are identical to the single-device run (GSPMD partitioning
        does not change the computation), so results match bit-for-bit."""
        cam = scene.camera
        w, h = cam.width, cam.height
        n = w * h
        d = self.pss_dims
        base = make_stream(seed)

        iota = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
        px = jnp.remainder(iota, w)
        py = iota // w

        cross_pix = []
        cross_valid = []
        for dx, dy in _CROSS:
            cx = px + dx
            cy = py + dy
            ok = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            cross_pix.append(jnp.stack([jnp.clip(cx, 0, w - 1),
                                        jnp.clip(cy, 0, h - 1)], -1))
            cross_valid.append(ok)
        cross_valid = jnp.stack(cross_valid, 1)           # [n, 5]
        cross_pid = jnp.stack(
            [p[:, 1] * w + p[:, 0] for p in cross_pix], 1)  # [n, 5]

        # one batched eval over all 5 cross positions: [5n] lanes share the
        # tile's PSS vector (sequence replay == array reuse)
        cross_all = jnp.concatenate(cross_pix, axis=0)    # [5n, 2]

        def generate_state(scene, u):
            """Evaluate the PSS vector at every cross pixel (same sequence)."""
            u5 = jnp.tile(u, (5, 1))
            stream = ArrayStream(values=u5, counter=jnp.int32(0))
            li = self.integrator.compute_pixel(scene, cross_all, stream)
            li = jnp.where(jnp.all(jnp.isfinite(li), -1, keepdims=True), li, 0.0)
            col = li.reshape(5, n, 3).swapaxes(0, 1)      # [n, 5, 3]
            col = jnp.where(cross_valid[..., None], col, 0.0)
            tf = jnp.sum(jnp.max(col, axis=-1), axis=1)   # sum of channel_max
            return col, tf

        def mutate_smcmc(u, r, fresh01):
            """Kelemen everywhere, uniform resample of the pixel-jitter dims."""
            v = kelemen_mutate(u, r)
            return v.at[:, 0:2].set(fresh01)

        def mcmc_step(scene, carry, stream, exchange_axis=None, offset=0):
            """One schedule step. exchange_axis None -> independent MCMC;
            'h'/'v' -> replica exchange along x/y with pair offset."""
            (u, tf, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u) = carry

            if exchange_axis is None:
                ul, stream = _uniform(stream, (n,))
                uf, stream = _uniform(stream, (n, d))
                um, stream = _uniform(stream, (n, d))
                u01, stream = _uniform(stream, (n, 2))
                ua, stream = _uniform(stream, (n,))
                uninit = tf <= 0.0
                large = (ul < self.large_prob) | uninit
                u_prop = jnp.where(large[:, None], uf,
                                   mutate_smcmc(u, um, u01))
                col_p, tf_p = generate_state(scene, u_prop)

                # normalization accumulators on large steps (splat_state_uni).
                # NOTE: the reference weights value_mc by weight/tf which is
                # always 0 at that point (smcmc.rs:144-152), killing its own
                # IRLS regularization; we accumulate the plain MC estimate,
                # which is the clear intent.
                b_acc = b_acc + jnp.where(large, tf_p, 0.0)
                nb_u = nb_u + large.astype(jnp.int32)
                acc_mc = acc_mc + jnp.where(large[:, None, None], col_p, 0.0)

                a = jnp.minimum(1.0, tf_p / jnp.maximum(tf, 1e-30))
                a = jnp.where(tf_p > 0.0, a, 0.0)
                a = jnp.where(uninit, jnp.where(tf_p > 0.0, 1.0, 0.0), a)
                w_cur = wgt + (1.0 - a)
                accept = (ua < a) | (uninit & (tf_p > 0.0))

                spl_col = jnp.where(accept[:, None, None], col, col_p)
                spl_tf = jnp.where(accept, tf, tf_p)
                spl_w = jnp.where(accept, w_cur, a)
                good = spl_tf > 0.0
                acc_v = acc_v + jnp.where(
                    good[:, None, None],
                    spl_col * (spl_w / jnp.maximum(spl_tf, 1e-30))[:, None, None],
                    0.0)
                nb_s = nb_s + (~uninit).astype(jnp.int32)

                u = jnp.where(accept[:, None], u_prop, u)
                tf = jnp.where(accept, tf_p, tf)
                col = jnp.where(accept[:, None, None], col_p, col)
                wgt = jnp.where(accept, a, w_cur)
            else:
                # Pairwise neighbor access via rolls on the (h, w) grid, NOT
                # index gathers: when the lane axis is device-split (mesh
                # rendering), XLA lowers the roll on the split axis to a
                # collective-permute of just the halo rows — the
                # ppermute form of the reference's even/odd replica exchange
                # (smcmc.rs:1248-1327, P4 in SURVEY.md §2.10).
                if exchange_axis == "h":
                    even = (px - offset) % 2 == 0
                    partner_c = jnp.where(even, px + 1, px - 1)
                    pvalid = (partner_c >= 0) & (partner_c < w)
                    roll_ax = 1
                else:
                    even = (py - offset) % 2 == 0
                    partner_c = jnp.where(even, py + 1, py - 1)
                    pvalid = (partner_c >= 0) & (partner_c < h)
                    roll_ax = 0

                def nb(arr):
                    """Value of `arr` at the partner lane (wrap content is
                    masked out by pvalid)."""
                    a2 = arr.reshape((h, w) + arr.shape[1:])
                    nxt = jnp.roll(a2, -1, axis=roll_ax)
                    prv = jnp.roll(a2, +1, axis=roll_ax)
                    e2 = even.reshape((h, w) + (1,) * (arr.ndim - 1))
                    return jnp.where(e2, nxt, prv).reshape(arr.shape)

                u_sw = jnp.where(pvalid[:, None], nb(u), u)
                col_p, tf_p = generate_state(scene, u_sw)
                ua, stream = _uniform(stream, (n,))
                # joint acceptance shared within the pair: use the uniform of
                # the lower-index (even) lane
                ua_pair = jnp.where(even, ua, nb(ua))
                tf_nb = nb(tf)
                prod_new = tf_p * nb(tf_p)
                prod_old = tf * tf_nb
                a = jnp.minimum(1.0, prod_new / jnp.maximum(prod_old, 1e-30))
                a = jnp.where((prod_new > 0.0) & pvalid, a, 0.0)
                bothinit = (tf > 0.0) & (tf_nb > 0.0)
                a = jnp.where(bothinit, a, 0.0)
                accept = (ua_pair < a) & pvalid & bothinit

                w_cur = wgt + (1.0 - a)
                spl_col = jnp.where(accept[:, None, None], col, col_p)
                spl_tf = jnp.where(accept, tf, tf_p)
                spl_w = jnp.where(accept, w_cur, a)
                good = (spl_tf > 0.0) & bothinit
                acc_v = acc_v + jnp.where(
                    good[:, None, None],
                    spl_col * (spl_w / jnp.maximum(spl_tf, 1e-30))[:, None, None],
                    0.0)
                nb_s = nb_s + bothinit.astype(jnp.int32)

                u = jnp.where(accept[:, None], u_sw, u)
                tf = jnp.where(accept, tf_p, tf)
                col = jnp.where(accept[:, None, None], col_p, col)
                wgt = jnp.where(accept, a, jnp.where(bothinit & pvalid, w_cur, wgt))
                # borrow: uninit chains adopt an initialized partner's state
                borrow = (tf <= 0.0) & pvalid & (tf_p > 0.0)
                u = jnp.where(borrow[:, None], u_sw, u)
                tf = jnp.where(borrow, tf_p, tf)
                col = jnp.where(borrow[:, None, None], col_p, col)
                wgt = jnp.where(borrow, 0.0, wgt)

            return (u, tf, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u), stream

        def generate_state_at(scene, pos, u):
            """generate_state for chains at arbitrary tile positions
            (the roaming chains of MCMCInit)."""
            m = pos.shape[0]
            cps, cvs = [], []
            for dx, dy in _CROSS:
                cx = pos[:, 0] + dx
                cy = pos[:, 1] + dy
                cvs.append((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h))
                cps.append(jnp.stack([jnp.clip(cx, 0, w - 1),
                                      jnp.clip(cy, 0, h - 1)], -1))
            cv = jnp.stack(cvs, 1)
            u5 = jnp.tile(u, (5, 1))
            stream = ArrayStream(values=u5, counter=jnp.int32(0))
            li = self.integrator.compute_pixel(scene,
                                               jnp.concatenate(cps, 0), stream)
            li = jnp.where(jnp.all(jnp.isfinite(li), -1, keepdims=True), li, 0.0)
            col = li.reshape(5, m, 3).swapaxes(0, 1)
            col = jnp.where(cv[..., None], col, 0.0)
            return col, jnp.sum(jnp.max(col, axis=-1), axis=1)

        def init_states(scene, stream):
            """Per-tile starting states + normalization accumulators.
            independent: IndependentInit (smcmc.rs:916-972); mcmc: MCMCInit
            roaming-chain reservoir deposit (smcmc.rs:974-1172)."""
            u0, stream = _uniform(stream, (n, d))
            col0, tf0 = generate_state(scene, u0)
            b_acc, nb_u, acc_mc = tf0, jnp.ones(n, jnp.int32), col0

            if self.init == "independent":
                for _ in range(max(self.init_spp - 1, 0)):
                    uk, stream = _uniform(stream, (n, d))
                    colk, tfk = generate_state(scene, uk)
                    b_acc = b_acc + tfk
                    nb_u = nb_u + 1
                    acc_mc = acc_mc + colk
                    take = (tf0 <= 0.0) & (tfk > 0.0)
                    u0 = jnp.where(take[:, None], uk, u0)
                    col0 = jnp.where(take[:, None, None], colk, col0)
                    tf0 = jnp.where(take, tfk, tf0)
                return u0, tf0, col0, b_acc, nb_u, acc_mc, stream

            # ---- mcmc init: seed roaming chains from the flux CDF
            m = max((n * self.init_spp_mcmc) // self.init_chain_length, 64)
            cdf = jnp.cumsum(tf0)
            tot = jnp.maximum(cdf[-1], 1e-30)
            uc, stream = _uniform(stream, (m,))
            v = (jax.lax.broadcasted_iota(jnp.float32, (m,), 0) + uc) / m * tot
            idx = jnp.clip(jnp.searchsorted(cdf, v), 0, n - 1)
            # one-time gather (init only: m*d elements once per render)
            ch_u = jnp.take(u0, idx, axis=0)
            ch_pos = jnp.stack([jnp.remainder(idx, w), idx // w], -1)
            ch_col, ch_tf = generate_state_at(scene, ch_pos, ch_u)

            def body(_, carry):
                (t_u, t_tf, t_col, nb_visit,
                 ch_pos, ch_u, ch_tf, ch_col, stream) = carry
                pid = ch_pos[:, 1] * w + ch_pos[:, 0]
                # batch reservoir update: each tile replaces its state with a
                # uniformly-chosen visitor with prob visits/(nb_visit+visits)
                # (equivalent to the reference's sequential 1/nb_visit rule)
                visits = jnp.zeros(n).at[pid].add(1.0)
                nb_new = nb_visit + visits
                key, stream = _uniform(stream, (m,))
                keymax = jnp.full(n, -1.0).at[pid].max(key)
                winner = key == keymax[pid]
                ur, stream = _uniform(stream, (n,))
                repl = (visits > 0.0) & (ur < visits / jnp.maximum(nb_new, 1.0))
                sel = winner & repl[pid] & (ch_tf > 0.0)
                tgt = jnp.where(sel, pid, n)
                t_u = t_u.at[tgt].set(ch_u, mode="drop")
                t_tf = t_tf.at[tgt].set(ch_tf, mode="drop")
                t_col = t_col.at[tgt].set(ch_col, mode="drop")

                # image-space move (Kelemen on normalized coords) + PSS
                # small-step, MH accept on tf (smcmc.rs:1121-1163)
                r2, stream = _uniform(stream, (m, 2))
                posn = jnp.stack([(ch_pos[:, 0] + 0.5) / w,
                                  (ch_pos[:, 1] + 0.5) / h], -1)
                posn = kelemen_mutate(posn, r2)
                new_pos = jnp.stack(
                    [jnp.clip((posn[:, 0] * w).astype(jnp.int32), 0, w - 1),
                     jnp.clip((posn[:, 1] * h).astype(jnp.int32), 0, h - 1)],
                    -1)
                um, stream = _uniform(stream, (m, d))
                u01, stream = _uniform(stream, (m, 2))
                u_prop = mutate_smcmc(ch_u, um, u01)
                col_p, tf_p = generate_state_at(scene, new_pos, u_prop)
                ua, stream = _uniform(stream, (m,))
                a = jnp.minimum(1.0, tf_p / jnp.maximum(ch_tf, 1e-30))
                acc = (ua < a) & (tf_p > 0.0)
                ch_pos = jnp.where(acc[:, None], new_pos, ch_pos)
                ch_u = jnp.where(acc[:, None], u_prop, ch_u)
                ch_tf = jnp.where(acc, tf_p, ch_tf)
                ch_col = jnp.where(acc[:, None, None], col_p, ch_col)
                return (t_u, t_tf, t_col, nb_visit + visits,
                        ch_pos, ch_u, ch_tf, ch_col, stream)

            carry = (u0, tf0, col0, jnp.zeros(n),
                     ch_pos, ch_u, ch_tf, ch_col, stream)
            carry = jax.lax.fori_loop(0, self.init_chain_length, body, carry)
            t_u, t_tf, t_col = carry[0], carry[1], carry[2]
            return t_u, t_tf, t_col, b_acc, nb_u, acc_mc, carry[-1]

        # schedule MCMC/H0/MCMC/V0/MCMC/H1/MCMC/V1 (smcmc.rs:1335-1355) via a
        # lax.switch inside a fori_loop — one compiled body, any spp
        schedule = [None, ("h", 0), None, ("v", 0), None, ("h", 1), None, ("v", 1)]

        if mesh is None:
            def shard_lanes(x):
                return x
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            def shard_lanes(x):
                nd = getattr(x, "ndim", 0)
                if nd >= 1 and x.shape[0] == n:
                    s = NamedSharding(mesh, P(*(("d",) + (None,) * (nd - 1))))
                    return jax.lax.with_sharding_constraint(x, s)
                return x

        from ..common import _BLOCK_CACHE, _cache_put

        branches = []
        for step in schedule:
            if step is None:
                branches.append(lambda c, st: mcmc_step(scene, c, st))
            else:
                ax, off = step
                branches.append(
                    lambda c, st, ax=ax, off=off: mcmc_step(
                        scene, c, st, exchange_axis=ax, offset=off))

        ik = (id(scene), id(self), w, h, "smcmc-init")
        make_init = _BLOCK_CACHE.get(ik)
        if make_init is None:
            @jax.jit
            def make_init(base_fold):
                u0, tf0, col0, b_acc0, nb_u0, acc_mc0, stream0 = init_states(
                    scene, base_fold)
                carry0 = (u0, tf0, col0, jnp.zeros(n),
                          jnp.zeros((n, 5, 3)), acc_mc0,
                          jnp.zeros(n, jnp.int32), b_acc0, nb_u0)
                return carry0, stream0
            _cache_put(ik, make_init)

        ek = (id(scene), id(self), spp, w, h, id(mesh), "smcmc-run")
        evolve = _BLOCK_CACHE.get(ek)
        if evolve is None:
            @jax.jit
            def evolve(carry0, stream0):
                carry0 = jax.tree.map(shard_lanes, carry0)

                def body(s, state):
                    carry, stream = state
                    return jax.lax.switch(jnp.remainder(s, 8), branches,
                                          carry, stream)

                carry, _ = jax.lax.fori_loop(0, spp, body,
                                             (carry0, stream0))
                return carry
            _cache_put(ek, evolve)

        import time
        t0 = time.time()
        st = self._chain_state
        # key chain persistence on the scene OBJECT (not id(): a collected
        # scene's address can be reused, silently resuming foreign chains)
        if self.keep_chains and st is not None and st[0] is scene:
            carry0 = st[1]
            stream0 = stream_fold(base, 31337)
        else:
            carry0, stream0 = make_init(stream_fold(base, 31337))
        if self.capture_hlo:
            # lower the REAL sharded step (the one about to run) and stash
            # its compiled HLO so callers can assert on the production
            # collective, not a stand-in
            self.last_hlo = evolve.lower(carry0, stream0).compile().as_text()
        carry = evolve(carry0, stream0)
        if self.keep_chains:
            self._chain_state = (scene, carry)
        (u, tf, col, wgt, acc_v, acc_mc, nb_s, b_acc, nb_u) = carry
        # flush final states
        good = tf > 0.0
        acc_v = acc_v + jnp.where(
            good[:, None, None],
            col * (wgt / jnp.maximum(tf, 1e-30))[:, None, None], 0.0)
        if verbose:
            print(f"smcmc: {n} tile-chains x {spp} steps in {time.time()-t0:.2f}s")

        if self.recons == "irls":
            img = _irls_reconstruction(
                np.asarray(acc_v), np.asarray(acc_mc), np.asarray(nb_s),
                np.asarray(b_acc), np.asarray(nb_u),
                np.asarray(cross_valid), np.asarray(cross_pid), w, h)
            film = Film(w, h)
            film.buffers["primal"] = img.reshape(h, w, 3)
            return film

        # naive overlap reconstruction (smcmc.rs:318-358)
        norm = jnp.where(nb_u > 0, b_acc / jnp.maximum(nb_u, 1), 0.0)
        accum = jnp.zeros((n, 3))
        counts = jnp.zeros((n,))
        vals = acc_v * norm[:, None, None]
        for s in range(5):
            contrib = jnp.where((cross_valid[:, s] & (nb_s > 0))[:, None],
                                vals[:, s], 0.0)
            accum = accum.at[cross_pid[:, s]].add(contrib, mode="drop")
            counts = counts.at[cross_pid[:, s]].add(
                jnp.where(cross_valid[:, s], nb_s.astype(jnp.float32), 0.0),
                mode="drop")
        img = jnp.where(counts[:, None] > 0, accum / jnp.maximum(counts[:, None], 1.0), 0.0)

        film = Film(w, h)
        film.buffers["primal"] = np.asarray(img).reshape(h, w, 3)
        return film


# slot layout: 0=center, 1=left(dx=-1), 2=top(dy=-1), 3=right(+1), 4=down(+1)
# overlap rules (cur_slot, next_slot, (dy, dx)) — smcmc.rs:491-695
_IRLS_PAIRS = [
    (0, 3, (0, -1)), (1, 0, (0, -1)),      # left neighbor
    (0, 1, (0, +1)), (3, 0, (0, +1)),      # right neighbor
    (0, 4, (-1, 0)), (2, 0, (-1, 0)),      # top neighbor
    (0, 2, (+1, 0)), (4, 0, (+1, 0)),      # down neighbor
    (2, 3, (-1, -1)), (1, 4, (-1, -1)),    # top-left diagonal
    (4, 1, (+1, +1)), (3, 2, (+1, +1)),    # down-right diagonal
    (4, 3, (+1, -1)), (1, 2, (+1, -1)),    # down-left diagonal
    (2, 1, (-1, +1)), (3, 4, (-1, +1)),    # top-right diagonal
    (1, 3, (0, -2)), (3, 1, (0, +2)),      # distance-2 horizontal
    (2, 4, (-2, 0)), (4, 2, (+2, 0)),      # distance-2 vertical
]


def _irls_reconstruction(acc_v, acc_mc, nb_s, b_acc, nb_u, cross_valid,
                         cross_pid, w, h, irls_iter=4, internal_iter=20,
                         alpha=0.1):
    """IRLS overlap-consistency solve (reference ReconstructionIRLS,
    smcmc.rs:359-904), vectorized with numpy rolls; per channel."""
    n = w * h

    def rolled(img2d, off):
        """value at the neighbor p + (dy, dx); mask False where out of bounds."""
        dy, dx = off
        r = np.roll(img2d, (-dy, -dx), axis=(0, 1))
        valid = np.ones((h, w), bool)
        if dy > 0:
            valid[h - dy:, :] = False
        elif dy < 0:
            valid[:-dy, :] = False
        if dx > 0:
            valid[:, w - dx:] = False
        elif dx < 0:
            valid[:, :-dx] = False
        return r, valid

    out_b = np.zeros((n, 3), np.float32)
    # robust per-pixel MC estimate (weighted_reconstruction_channel)
    for ch in range(3):
        mc_acc = np.zeros(n, np.float64)
        mc_cnt = np.zeros(n, np.int64)
        for s in range(5):
            np.add.at(mc_acc, cross_pid[:, s],
                      np.where(cross_valid[:, s], acc_mc[:, s, ch], 0.0))
            np.add.at(mc_cnt, cross_pid[:, s],
                      np.where(cross_valid[:, s], nb_u, 0))
        mc_est = np.where(mc_cnt > 0, mc_acc / np.maximum(mc_cnt, 1), 0.0)

        cache = np.where(cross_valid, acc_v[:, :, ch], 0.0)  # [n, 5]
        sums_mcmc = cache.sum(1)
        sums_mc = np.where(cross_valid, mc_est[cross_pid], 0.0).sum(1)
        b = np.where(nb_u > 0, b_acc / np.maximum(nb_u, 1), 0.0).astype(np.float64)
        wgt = np.ones(n, np.float64)

        cache2 = cache.reshape(h, w, 5)

        def apply_op(b, wgt, error_mode):
            b2 = b.reshape(h, w)
            w2 = wgt.reshape(h, w)
            force = np.zeros((h, w))
            pos = np.zeros((h, w))
            err = np.zeros((h, w))

            def update(v1, b1, w1, v2, b2_, w2_, valid):
                al = valid & (v1 != 0.0) & (v2 != 0.0)
                f = 0.5 * (v1 * b1 - v2 * b2_)
                ww = np.minimum(w1, w2_)
                if error_mode:
                    err[al] += np.abs(f)[al]
                else:
                    force[al] += (ww * f)[al]
                    pos[al] += (ww * v1)[al]

            # regularization vs the MC estimate (smcmc.rs:506-511). The MCMC
            # sums accumulate one splat per step while the MC estimate is
            # per-sample, so normalize by the step count (the reference's own
            # regularization never fires due to its value_mc weight bug, so
            # this scale is ours to fix).
            update((sums_mcmc / np.maximum(nb_s, 1)).reshape(h, w), b2,
                   alpha * w2,
                   sums_mc.reshape(h, w), np.ones((h, w)), alpha * w2,
                   np.ones((h, w), bool))
            for s1, s2, off in _IRLS_PAIRS:
                v2r, valid = rolled(cache2[:, :, s2], off)
                b2r, _ = rolled(b2, off)
                w2r, _ = rolled(w2, off)
                update(cache2[:, :, s1], b2, w2, v2r, b2r, w2r, valid)
            if error_mode:
                return err.reshape(n)
            newb = np.where(pos != 0.0, b2 - force / np.where(pos != 0, pos, 1.0), b2)
            newb = np.where(np.isfinite(newb), newb, b2)
            return np.maximum(newb.reshape(n), 0.0)

        for it in range(irls_iter):
            for _ in range(internal_iter):
                b = np.where(sums_mcmc > 0, apply_op(b, wgt, False), b)
            err = apply_op(b, wgt, True)
            w_new = 1.0 / (err + max(0.05 * 0.5 ** it, 1e-4))
            wgt = w_new * n / max(w_new.sum(), 1e-12)
        out_b[:, ch] = b.astype(np.float32)

    # final splat: value * per-tile b, averaged by overlap counts
    accum = np.zeros((n, 3), np.float64)
    counts = np.zeros(n, np.int64)
    vals = acc_v * out_b[:, None, :]
    for s in range(5):
        ok = cross_valid[:, s] & (nb_s > 0)
        np.add.at(accum, cross_pid[:, s], np.where(ok[:, None], vals[:, s], 0.0))
        np.add.at(counts, cross_pid[:, s], np.where(ok, nb_s, 0))
    img = np.where(counts[:, None] > 0, accum / np.maximum(counts[:, None], 1), 0.0)
    return img.astype(np.float32)
