"""``LangevinDynamics`` or ``HamiltonianMonteCarlo`` ``.sample`` on the ring:
one call is one batch of chains run for ``n_steps`` steps (draws).

Each call takes the next start of the pool and the run's one generator,
from which the sampler draws its kernel's seed. The check takes
``check_calls`` calls of the window, drawn from the seed, with the
generator's state before each, and runs the reference's chains from the same
start with the seed drawn from that state. Numbers: the widest gap of a
chain's final state, ``max |x - x_ref|``, and the share of chains whose gap
passes ``OFF`` (after 1,000 HMC draws on the ring a few percent of chains
leave the reference's path, from rounding alone; see PERF.md), and the
median gap.
"""

from __future__ import annotations


import torch

from perfbench import generate
from perfbench.counts import chains as chain_counts
from perfbench.entries import Reservoir, free, sync
from perfbench.reference import ring
from perfbench.systems import mixture_ring

#: a chain whose final state lies farther than this from the reference's is off
OFF = 1e-2
KERNELS = {"langevin": "mixture_langevin_chain", "hmc": "mixture_hmc_chain"}


class Cell:
    def __init__(self, config, traffic, seed, device, fused="auto"):
        from torchebm_tpu_torch.samplers import HamiltonianMonteCarlo, LangevinDynamics

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        energy = mixture_ring.build(config, device)
        kind = traffic["sampler"]
        if kind == "langevin":
            self.sampler = LangevinDynamics(energy, step_size=traffic["step_size"], fused=fused)
            work = chain_counts.langevin(traffic["n_chains"], config["dim"],
                                         config["n_components"], traffic["n_steps"])
        elif kind == "hmc":
            self.sampler = HamiltonianMonteCarlo(energy, step_size=traffic["step_size"],
                                                 n_leapfrog_steps=traffic["n_leapfrog"],
                                                 fused=fused)
            work = chain_counts.hmc(traffic["n_chains"], config["dim"], config["n_components"],
                                    traffic["n_steps"], traffic["n_leapfrog"])
        else:
            raise ValueError(f"unknown sampler {kind!r}")
        self.gen = generate.generator(seed, "sampler", device)
        self.pool = generate.make_pool(traffic, config, seed, device)
        self.units = traffic["n_chains"] * traffic["n_steps"]
        self.work = {"kernel": KERNELS[kind], "chain_work": work}
        self.keep = Reservoir(traffic["check_calls"], generate.subseed(seed, "keep"))
        for i in range(traffic["warmup_calls"]):
            self._sample(i)
        self.offset = traffic["warmup_calls"]
        sync(device)

    def _sample(self, i):
        return self.sampler.sample(self.gen, x=self.pool[i % len(self.pool)]["x"],
                                   n_steps=self.traffic["n_steps"])

    def call(self, i):
        slot = self.keep.slot()
        if slot is None:
            return self._sample(self.offset + i)
        state = self.gen.get_state()
        out = self._sample(self.offset + i)
        self.keep.kept[slot] = ((self.offset + i) % len(self.pool), state, out)
        return out

    def readings(self) -> dict:
        return dict(self.keep.kept)

    def release(self):
        self.sampler = None
        free(self.device)

    def reference(self, got, precision=None) -> dict:
        cfg, tr = self.config, self.traffic
        dtype = {None: torch.float32, "bf16": torch.bfloat16}[precision]
        pool = generate.make_pool(tr, cfg, self.seed, self.device)
        means = ring.ring_means(cfg, self.device)
        out = {}
        for slot, (k, state, _) in got.items():
            seed = ring.kernel_seed(state, self.device)
            x0 = pool[k]["x"]
            if tr["sampler"] == "langevin":
                x = ring.langevin(x0, means, cfg["scale"], tr["step_size"], tr["n_steps"], seed,
                                  dtype)
            else:
                x = ring.hmc(x0, means, cfg["scale"], tr["step_size"], tr["n_leapfrog"],
                             tr["n_steps"], seed, dtype)
            out[slot] = (k, state, x)
        return out


def compare(got: dict, want: dict) -> dict:
    gaps = []
    for slot, (k, _, x) in got.items():
        kw, _, ref = want[slot]
        if kw != k:
            raise ValueError(f"slot {slot}: start {k} against the reference's {kw}")
        gaps.append((x - ref).abs().amax(dim=1))
    gap = torch.cat(gaps)
    return {"state_gap_max": float(gap.max()), "state_gap_median": float(gap.median()),
            "chains_off": float((gap > OFF).double().mean())}


def setup(config, traffic, seed, device):
    # on the CPU the samplers' loops draw other numbers than the kernels;
    # "force" runs the kernels' plain versions there (the CPU tests' path)
    fused = "auto" if torch.device(device).type == "cuda" else "force"
    return Cell(config, traffic, seed, device, fused)
