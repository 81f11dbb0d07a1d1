"""Work of one kernel call: instructions by class and bytes moved.

A kernel's least time on a card is the larger of its bytes over the memory
rate and, per instruction class, its instruction count over the class's
rate. The counts here are taken by hand from the CUDA sources under
``csrc/``, per unit of work (one chain-step, one transition, one quad of
elements), and are an approximation (shared-memory loads, the neural
chain's main other instruction, are not counted): the compiler's own instruction mix is
not read. Classes: ``"fp32"`` adds, multiplies, FMAs, min/max and compares;
``"int32"`` Philox's multiplies, xors and key adds; ``"sfu"`` ex2, lg2, rsq,
rcp, sin, cos and int-to-float conversions; ``"tf32"`` floating-point
operations (two per multiply-add) on the tensor cores, at the card's dense
TF32 rate: the neural chain's products, counted as its three 3xTF32 passes
(``hi.hi + hi.lo + lo.hi``), whose splits into hi and lo are not counted.

The counts are the algorithm's work, not what a design adds to it. The
mixture, MALA, HMC, ladder and AIS chains (``mixture_langevin*``,
``mixture_mala*``, ``mixture_hmc*``, ``pt_langevin*``, ``mixture_ais_run``)
split a chain (on the ladder, each replica) over a group of lanes: their
butterfly shuffles and
broadcasts, the exchange's shuffles, the updates, residual and kinetic sums,
Metropolis tests and exchange decisions that every lane of a group repeats,
and the logits that lanes with no component form are overhead, so the counts
stay one evaluation and update per chain-step, replica-step or leapfrog
step, ``ceil(d/4)`` Philox blocks of normals and, for MALA, HMC and AIS,
one uniform block per chain-step, chain-draw or transition, for the ladder
one per pair tried, whatever the group (each block is drawn once, by one
lane). MALA's and AIS's bounds at their main shapes (the ring, the ESS
protocol's 2-D Gaussian, the AIS path's Gaussians) are set by their two
Philox blocks per step (INT32). The double-well chain needs one normal per
element-step: a quarter of a Philox block, and its kernel draws one block
per four steps of an element and uses all four normals. Every chain
kernel's ``chain_offset`` (a sharded batch's first row; the double well's
first element) is one add per chain (per element for the double well, per
tile for the neural chain; the MALA, HMC and AIS launchers move the
per-chain pointers back on the host) outside the step loop, and the
ladder's index ``r·total_chains + c + chain_offset`` one 64-bit
multiply-add per replica there: none is counted.

:data:`COUNTED_SOURCES` holds the SHA-256 prefix of each source the counts
were last checked against; a test fails when a source changes, so that an
edited kernel has its counts checked again before its hash is updated.
"""

from __future__ import annotations

__all__ = ["COUNTED_SOURCES", "work"]

#: ``{file under csrc/: sha256 hexdigest[:16]}`` of the sources counted here
COUNTED_SOURCES = {
    "fused_adaln.cu": "2babbb7de9382af3",
    "fused_ais.cu": "a7cacd3f918b0ea8",
    "fused_hmc.cu": "7828e20ad5034c76",
    "fused_langevin.cu": "325cefba2cc4636e",
    "fused_mala.cu": "87808bd546e0a5a9",
    "fused_mlp_langevin.cu": "888d1218c33b7485",
    "fused_pt.cu": "b71c6dbdd6dfca51",
    "fused_sinkhorn.cu": "dcc7fb5e563b09c8",
    "fused_gated_residual.cu": "b1341345116bf936",
    "fused_step.cu": "45698a16da6ceaad",
    "tebm_adaln.cuh": "b9620210d09473c0",
    "tebm_common.cuh": "678eb63445f8b37b",
}

# tebm_common.cuh: normals4 (one Philox4x32-10 block, two Box-Muller
# pairs); one normal (a quarter of that: one 32-bit word of a block, half a
# pair); uniform01 (one block, one conversion and scale)
_NORMALS4 = {"int32": 84, "fp32": 60, "sfu": 12}
_NORMAL = {k: v / 4 for k, v in _NORMALS4.items()}
_UNIFORM = {"int32": 84, "fp32": 2, "sfu": 1}


# the adaLN kernels, per value of the (B, N, D) stream and per token row (the
# per-sample loads of shift, scale and gate, and the column sums' block and
# chunk merges, are per sample and not counted). adaln_modulate: the mean's
# add, the deviation and its square-add, (x - mean)·rstd and the FMA with
# 1 + scale and shift; a row's rsqrt. Its backward: x^ (a subtract and a
# multiply), dscale's FMA and dshift's add, g = dz (1 + scale), the two row
# sums' add and FMA, dx's two subtracts, multiply and FMA with dres.
# gated_residual: one FMA; its backward dgate's FMA and dy's multiply. A
# row's warp shuffles (5 adds per sum) in each
_ADALN = {
    "adaln_modulate": ({"fp32": 6}, {"fp32": 12, "sfu": 1}),
    "adaln_modulate_backward": ({"fp32": 11}, {"fp32": 12}),
    "gated_residual": ({"fp32": 1}, {}),
    "gated_residual_backward": ({"fp32": 2}, {}),
}


def _add(*parts, times=1) -> dict:
    total = {"fp32": 0.0, "int32": 0.0, "sfu": 0.0, "tf32": 0.0}
    for p in parts:
        for k, v in p.items():
            total[k] += v * times
    return total


def _eval(d: int, k: int, gaussian: bool) -> dict:
    """One gradient + log-density evaluation (``grad_logp``, or
    ``grad_logp_group`` split over lanes, tebm_common.cuh) of a
    ``k``-component mixture or a full-covariance Gaussian in ``d``
    dimensions."""
    if gaussian:
        return {"fp32": d * d + 3 * d + 2}
    return {"fp32": k * (3 * d + 8) + 2 * d + 6, "sfu": k + 2}


def _isotropic(d: int) -> dict:
    """One evaluation of an isotropic Gaussian in closed form (fused_ais.cu's
    ``isotropic_grad_logp``): ``x − μ``, its scale and square sum, and the
    log-density's factor; no special function."""
    return {"fp32": 3 * d + 2}


def work(name: str, args, kw, result) -> dict:
    """``{"ops": {class: instructions}, "bytes": n}`` of one call of the
    kernel wrapper ``name`` with positional ``args`` and keywords ``kw``
    that returned ``result``: every tensor among them read or written once."""
    import torch

    def nbytes(xs):
        return sum(t.numel() * t.element_size() for t in xs if isinstance(t, torch.Tensor))

    flat = result if isinstance(result, tuple) else (result,)
    moved = nbytes([*args, *kw.values()]) + nbytes(flat)

    def normals(d):
        return _add(_NORMALS4, times=-(-d // 4))

    gaussian = kw.get("precision") is not None
    if name.startswith("mixture_langevin"):  # fused_langevin.cu, per chain-step, any group
        x0, means, n_steps = args[:3]
        n, d = x0.shape
        per = _add(_eval(d, means.shape[0], gaussian), normals(d), {"fp32": 4 * d})
        ops = _add(per, times=n * n_steps)
    elif name.startswith("doublewell"):  # fused_langevin.cu, per element-step
        x0, n_steps = args[:2]
        # one normal (the kernel draws one block per four steps and uses its
        # four normals); the gradient 4h x (x^2 - b^2), the update and the clamp
        ops = _add(_NORMAL, {"fp32": 7}, times=x0.numel() * n_steps)
    elif name.startswith("mixture_mala"):  # fused_mala.cu, per chain-step, any group
        x0, means, n_steps = args[:3]
        n, d = x0.shape
        per = _add(_eval(d, means.shape[0], gaussian), normals(d), _UNIFORM,
                   {"fp32": 8 * d + 12, "sfu": 2})
        ops = _add(per, times=n * n_steps)
    elif name.startswith("mixture_hmc"):  # fused_hmc.cu, per chain-draw, any group
        x0, means, n_draws, _, n_leap = args[:5]
        n, d = x0.shape
        ev = _eval(d, means.shape[0], gaussian)
        # a draw's n_leap evaluations with their kicks and drift; the state's
        # own gradient and log-density are kept from the draw before, so one
        # more evaluation per chain starts the run
        per = _add(_add(ev, {"fp32": 4 * d}, times=n_leap), normals(d), _UNIFORM,
                   {"fp32": 6 * d + 12, "sfu": 2})
        ops = _add(_add(per, times=n * n_draws), _add(ev, times=n))
    elif name.startswith("pt_langevin"):  # fused_pt.cu, per replica-step and pair tried
        ladder, means, n_steps, _, _, betas, swap_every = args[:7]
        n_rep, n, d = ladder.shape
        per_step = _add(_eval(d, means.shape[0], gaussian), normals(d), {"fp32": 4 * d})
        # per pair tried: its uniform, the decision (one exponential) and the
        # selects that exchange x, grad U and log p between the two replicas
        per_pair = _add(_UNIFORM, {"fp32": 8 + 2 * (2 * d + 1), "sfu": 1})
        # pairs (r, r + 1) with r % 2 == sweep % 2 (the single pair at R = 2)
        pairs = sum(1 if n_rep == 2 else (n_rep - s % 2) // 2
                    for s in range(n_steps // swap_every))
        ops = _add(_add(per_step, times=n_rep * n * n_steps), _add(per_pair, times=n * pairs))
    elif name == "mixture_ais_run":  # fused_ais.cu, per chain-transition and rung
        x0, _, _, means, betas = args[:5]
        n, d = x0.shape
        n_tr = kw.get("n_transitions", 1)
        rungs = betas.shape[0] - 1
        # the base in closed form; a one-component target too, plus its
        # log-weight
        k = means.shape[0]
        target = (_add(_isotropic(d), {"fp32": 1}) if k == 1 and not gaussian
                  else _eval(d, k, gaussian))
        per = _add(_isotropic(d), target, normals(d), _UNIFORM, {"fp32": 12 * d + 12, "sfu": 2})
        ops = _add(_add(per, times=n * n_tr * rungs), {"fp32": 4 * n * rungs})
    elif name == "mlp_langevin_chain":  # fused_mlp_langevin.cu, per chain-step
        x0, layers, n_steps = args[:3]
        n, d = x0.shape
        widths = [d] + [w.shape[1] for w, _ in layers[:-1]]
        pairs = list(zip(widths[:-1], widths[1:]))
        # forward and backward products: a layer of 8 or more inputs on the
        # tensor cores (2 operations per multiply-add, 3 passes), a narrower
        # one (the first at d = 2) on FP32 FMAs
        tensor = sum(2 * 3 * 2 * i * o for i, o in pairs if i >= 8)
        fmas = sum(2 * i * o for i, o in pairs if i < 8)
        hidden = sum(widths[1:])
        # per hidden unit the sigmoid (expf's range reduction, 1 + e, the
        # reciprocal's refinement: ex2 and rcp on the SFU), silu and silu', the
        # delta product and the next delta's scale; per coordinate the update
        # and the clamp
        per = _add(normals(d), {"fp32": fmas + 13 * hidden + 4 * d, "sfu": 2 * hidden,
                                "tf32": tensor})
        ops = _add(per, times=n * n_steps)
        moved += nbytes([t for pair in layers for t in pair])
    elif name == "fused_langevin_step":  # fused_step.cu, per quad of elements
        x, _, _, noise_scale = args[:4]
        quads = -(-x.numel() // 4)
        drawn = noise_scale and kw.get("noise") is None
        ops = _add(_NORMALS4 if drawn else {}, {"fp32": 12}, times=quads)
    elif name == "sinkhorn_log_fused":  # fused_sinkhorn.cu, per matrix element and iteration
        cost, _, n_iters = args[:3]
        n, m = cost.shape
        # the iterations this call ran: the kernel's own count when the call
        # returned it, else the cap (exact at tol == 0)
        iters = int(result[1]) if isinstance(result, tuple) else int(n_iters)
        # an iteration is a row pass and a column pass, each one sweep that
        # reads an element once: add the potential, the running max, subtract
        # it, exp2f (one ex2 and about three FP32 operations around it), add
        # to the sum; per row and column and iteration the lanes' merge, one
        # log2f and the update, and per column the bands' merge
        per_element = {"fp32": 14, "sfu": 2}
        per_vector_entry = {"fp32": 14, "sfu": 2}
        ops = _add(_add(per_element, times=n * m * iters),
                   _add(per_vector_entry, times=(n + m) * iters),
                   # M = C * (-log2 e / reg), and the plan (M + f + g) ln 2
                   {"fp32": 4 * n * m})
        # C read once and the plan written once from device memory; what an
        # iteration re-reads comes from shared memory or L2
        moved = 2 * 4 * n * m
    elif name in _ADALN:  # fused_adaln.cu, fused_gated_residual.cu, per value of the stream
        x = args[0]
        per_value, per_row = _ADALN[name]
        ops = _add(_add(per_value, times=x.numel()), _add(per_row, times=x.numel() // x.shape[-1]))
    else:
        raise KeyError(f"no instruction counts for kernel {name!r}")
    return {"ops": ops, "bytes": moved}
