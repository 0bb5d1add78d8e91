"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check.

The system under test is ``free_hunch_tpu_torch``'s guided sampler as
``generate_conditional`` runs it: ``samplers.edm.sample_loop`` driving Free Hunch
(``choose_conditioning_mechanism("online_covariance")``) over the
configuration's denoiser, which its family's ``program/<family>.py``
builds (the ``adm`` family: the ADM UNet behind the iDDPM linear
preconditioner), with the operator from ``operators.get_operator``. The
benchmark makes the weights, images, operators, measurements and noise
from ``--seed`` and hands them in.

The window is a closed loop of whole sampling runs, back to back, each
from sigma_max with fresh inputs. The harness wraps the mechanism it hands
``sample_loop`` (the sampler-guidance boundary): it counts the guided calls,
reads the program's CG counters from the state each call returns, copies
the first run's start and sampled calls to pinned host memory for the check,
and at the first call that starts after ``seconds`` synchronises and
closes the window. A later run stops there; the first run, if the window
closes inside it, goes on untimed to its end, so that the check finds
every step it samples.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import compare
import flops
import inputs
import spec
import devtrace
import weights as weights_mod
from reference import freehunch as ref_fh

SPANS = ("bench.denoise", "bench.call", "groupnorm_silu_backward")


class Stop(Exception):
    """Raised at a guided call's start to end a sampling run early."""


def calls_per_run(steps: int) -> int:
    return 2 * steps - 1


def sampled_steps(seed: int, sched: dict, bands) -> List[int]:
    """One step from each band (lo, hi) of sigma_hat that holds one, drawn
    from the seed."""
    g = inputs.generator(seed, 0, "check")
    out = []
    for lo, hi in bands:
        cand = [i for i, s in enumerate(sched["sigma_hat"]) if lo < float(s) < hi]
        if cand:
            out.append(cand[int(torch.randint(len(cand), (), generator=g))])
    return sorted(set(out))


# -- the program ------------------------------------------------------------------

class Program:
    """The system under test for one cell on ``device``: the denoiser its
    family's program module builds, with the configuration's ``program``
    options (``options`` overrides them: the control's int8 torso)."""

    def __init__(self, cell: dict, w: Dict[str, torch.Tensor], device, **options):
        from free_hunch_tpu_torch import use_full_f32
        from free_hunch_tpu_torch.samplers import edm
        cfg, tr = cell["config"], cell["traffic"]
        self.cfg, self.tr, self.device = cfg, tr, device
        self.res = spec.reference(cfg).arch_of(cfg["model"]).image_size
        use_full_f32()
        family = spec.program(cfg)
        self.model, self.precond = family.build(cfg, w, device, **options)
        self.norms = family.norm_modules(self.model)
        self.edm = edm
        self.xs, self.sigma0 = edm.prepare_schedule(
            round_sigma=self.precond.round_sigma, net_sigma_min=self.precond.sigma_min,
            net_sigma_max=self.precond.sigma_max, num_steps=tr["steps"], solver="heun",
            discretization="edm", schedule="linear", scaling="none")
        self.capacity = edm.required_cov_capacity(self.xs)
        self.trace_denoise = False

    def denoise(self, x, sigma):
        if self.trace_denoise:
            with torch.profiler.record_function("bench.denoise"):
                return self.precond(x, sigma)
        return self.precond(x, sigma)

    def mechanism(self, run: inputs.Run):
        from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism
        from free_hunch_tpu_torch.operators import get_operator
        op, res = self.tr["operator"], self.res
        prior = self.cfg["prior"]
        return choose_conditioning_mechanism("online_covariance")(
            forward_operator=get_operator(op["name"], in_shape=(1, 3, res, res),
                                          sigma_s=op["sigma_y"], device=self.device,
                                          **run.op.program),
            image_base_covariance=prior["name"], dataset=prior.get("dataset", "imagenet"),
            data_dim=3 * res * res, cov_capacity=self.capacity, **self.tr["mechanism"])

    def sample(self, mech, run: inputs.Run):
        """One whole sampling run; returns the final x."""
        x, _ = self.edm.sample_loop(self.denoise, mech, run.noise, run.y, self.xs,
                                    sigma0_scaled=self.sigma0)
        return x


# -- pinned copies of the sampled calls -------------------------------------------

class _State:
    """Host copies of a FreeHunchState's tensors."""

    def __init__(self, b, shape, d, K, pin):
        f = dict(dtype=torch.float32, pin_memory=pin)
        self.diag = torch.empty((b, d), **f)
        self.Ut = torch.empty((b, K, d), **f)
        self.M = torch.empty((b, K, K), **f)
        self.k = torch.empty((b,), dtype=torch.int64, pin_memory=pin)
        self.prev_x = torch.empty((b,) + shape, **f)
        self.prev_mean = torch.empty((b,) + shape, **f)
        self.prev_u = torch.empty((b,) + shape, **f)
        self.prev_sigma, self.step, self.cg_niter = 0.0, 0, 0

    def copy(self, st):
        for k in ("diag", "Ut", "M", "k"):
            getattr(self, k).copy_(getattr(st.cov, k), non_blocking=True)
        for k in ("prev_x", "prev_mean", "prev_u"):
            getattr(self, k).copy_(getattr(st, k), non_blocking=True)
        self.prev_sigma, self.step = float(st.prev_sigma), int(st.step)
        self.cg_niter = int(st.cg_niter)

    def before(self, dev) -> ref_fh.Before:
        t = lambda a: a.to(dev)  # noqa: E731
        return ref_fh.Before(ref_fh.Cov(t(self.diag), t(self.Ut), t(self.M), t(self.k)),
                             self.prev_sigma, t(self.prev_x), t(self.prev_mean), t(self.prev_u),
                             self.step)


class _Step:
    """One sampled Heun step's copies: x_hat and the state its first call
    found, that call's output and state, the predictor x' and the second
    call's output, the step's result."""

    def __init__(self, i, b, shape, d, K, pin):
        f = dict(dtype=torch.float32, pin_memory=pin)
        self.i = i
        self.x_hat, self.d1, self.x_prime, self.d2, self.x_next = (
            torch.empty((b,) + shape, **f) for _ in range(5))
        self.st0, self.st1 = _State(b, shape, d, K, pin), _State(b, shape, d, K, pin)
        self.whole = False


class Captures:
    """Copies of the window's first run (run 0): its first call (the start)
    and its sampled steps. Run 0 always ends (``Boundary.close`` lets it
    finish untimed where the window closes inside it), so the check finds
    every sampled step whole; later runs copy nothing."""

    def __init__(self, steps: List[int], n_steps: int, b: int, shape, K: int, pin: bool):
        d = int(np.prod(shape))
        self.n_steps = n_steps
        f = dict(dtype=torch.float32, pin_memory=pin)
        self.steps = {i: _Step(i, b, shape, d, K, pin) for i in steps}
        self.x0 = torch.empty((b,) + shape, **f)
        self.diag = torch.empty((b, d), **f)
        self.zeros = torch.empty((6,), **f)
        self.started = False
        self.run = -1

    def begin(self, run: int):
        self.run = run

    def before(self, call: int, x_t, st):
        if self.run != 0:
            return
        if call == 0:
            self.x0.copy_(x_t, non_blocking=True)
            self.diag.copy_(st.cov.diag, non_blocking=True)
            eye = torch.eye(st.cov.M.shape[-1], device=st.cov.M.device)
            self.zeros.copy_(torch.stack([
                st.cov.Ut.abs().amax(), (st.cov.M - eye).abs().amax(),
                st.cov.k.abs().amax().float(), st.prev_x.abs().amax(),
                st.prev_mean.abs().amax(), st.prev_u.abs().amax()]), non_blocking=True)
        i, j = divmod(call, 2)
        if j == 0 and i - 1 in self.steps:
            self.steps[i - 1].x_next.copy_(x_t, non_blocking=True)
            self.steps[i - 1].whole = True
        step = self.steps.get(i)
        if step is None:
            return
        if j == 0:
            step.x_hat.copy_(x_t, non_blocking=True)
            step.st0.copy(st)
        else:
            step.x_prime.copy_(x_t, non_blocking=True)

    def after(self, call: int, x0, st):
        if self.run != 0:
            return
        self.started = True
        i, j = divmod(call, 2)
        step = self.steps.get(i)
        if step is None:
            return
        if j == 0:
            step.d1.copy_(x0, non_blocking=True)
            step.st1.copy(st)
        else:
            step.d2.copy_(x0, non_blocking=True)

    def end(self, x_final):
        """The run returned its final x: the last step's result."""
        step = self.steps.get(self.n_steps - 1)
        if self.run == 0 and step is not None:
            step.x_next.copy_(x_final, non_blocking=True)
            step.whole = True

    def whole(self) -> List[_Step]:
        """The sampled steps whose copies are whole."""
        return [st for _, st in sorted(self.steps.items()) if st.whole]


# -- the boundary ----------------------------------------------------------------

class Boundary:
    """The mechanism handed to ``sample_loop``: counts guided calls and the
    program's CG counters, copies the sampled calls, closes the window at a
    deadline (``close``), and in a traced run times each call
    (synchronised) and starts and stops the profiler."""

    def __init__(self, mech, captures: Optional[Captures], device):
        self.mech, self.captures, self.device = mech, captures, device
        self.deadline = None
        self.t_close, self.peak = None, 0
        self.sync = False
        self.calls = self.cg_iters = self.host_syncs = 0
        self.call_s: List[float] = []
        self.in_run = 0
        # traced stretches, consecutive: [(first call, calls, profiler, label)]
        self.stretches: List[tuple] = []
        self.stretch_s: Dict[str, float] = {}
        self.on_profile = lambda label, on: None

    def init_state(self, batch, shape):
        self.in_run = 0
        return self.mech.init_state(batch, shape)

    def close(self):
        """The deadline has passed: synchronise and read the window's end
        and the peak memory, once. A later run stops here (``Stop``); the
        first run (run 0) goes on untimed, uncounted, so that the check
        finds every step it samples."""
        if self.t_close is None:
            _sync(self.device)
            self.t_close = time.perf_counter()
            if torch.device(self.device).type == "cuda":
                self.peak = torch.cuda.max_memory_allocated()
        if self.captures is None or self.captures.run != 0:
            raise Stop
        self.deadline = None

    def __call__(self, denoise, x_t, y, sigma, state):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            self.close()
        c = self.in_run
        for k, (first, n, prof, label) in enumerate(self.stretches):
            if c == first + n:
                _sync(self.device)
                self.stretch_s[label] = time.perf_counter() - self.t_stretch
                prof.stop()
                self.on_profile(label, False)
                if k == len(self.stretches) - 1:
                    raise Stop
            if c == first:
                _sync(self.device)
                self.on_profile(label, True)
                self.t_stretch = time.perf_counter()
                prof.start()
        if self.captures is not None:
            self.captures.before(c, x_t, state)
        timed = self.sync and self.t_close is None
        if timed:
            _sync(self.device)
            t0 = time.perf_counter()
        with torch.profiler.record_function("bench.call"):
            x0, st = self.mech(denoise, x_t, y, sigma, state)
        if timed:
            _sync(self.device)
            self.call_s.append(time.perf_counter() - t0)
        if self.captures is not None:
            self.captures.after(c, x0, st)
        if self.t_close is None:
            self.calls += 1
            self.cg_iters += int(st.cg_niter)
            self.host_syncs += int(st.cg_host_syncs)
        self.in_run += 1
        return x0, st


def profiler_activities(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    return acts + [torch.profiler.ProfilerActivity.CUDA] if cuda else acts


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# -- norm byte counters for the traced stretch -------------------------------------

class NormBytes:
    """Forward hooks on the program's norm modules (its family's
    ``norm_modules``) while a stretch is on: the bytes of each K1 call (x
    read, y written) and of each pullback through a norm (x and dy read, dx
    written, counted when its gradient arrives), by stretch."""

    def __init__(self, modules):
        self.label = None
        self.counts: Dict[str, Dict[str, int]] = {}
        self.hooks = [m.register_forward_hook(self._hook) for m in modules]

    def switch(self, label, on):
        self.label = label if on else None
        self.counts.setdefault(label, dict(k1=0, k1_calls=0, bwd=0, bwd_calls=0))

    def _hook(self, mod, args, out):
        if self.label is None:
            return
        x, c = args[0], self.counts[self.label]
        c["k1"] += flops.k1_bytes(x.shape, x.element_size())
        c["k1_calls"] += 1
        if out.requires_grad:
            shape, size = tuple(x.shape), x.element_size()

            def grad_hook(g):
                c["bwd"] += flops.gn_backward_bytes(shape, size)
                c["bwd_calls"] += 1
            out.register_hook(grad_hook)

    def remove(self):
        for h in self.hooks:
            h.remove()


# -- one run of a cell -------------------------------------------------------------

def warm_up(program: Program, run: inputs.Run, captures: Optional[Captures]):
    """Three guided calls at the cell's shapes: the first call, a call in
    the space-update window after a move (time update, transport, BFGS
    pair) and one at the schedule's smallest sigma (the tightest CG)."""
    mech = Boundary(program.mechanism(run), None, program.device)
    xs = program.xs
    sig = [float(s) for s in xs["sigma_hat"]]
    win = next(s for s in sig if 1.0 < s < 10.0)
    st = mech.init_state(run.noise.shape[0], run.noise.shape[1:])
    x = run.noise * program.sigma0
    if captures is not None:
        captures.begin(0)
        captures.before(0, x, st)
    times = []
    for x_in, s in ((x, sig[0]), (None, win), (None, sig[-1])):
        t = time.perf_counter()
        if x_in is None:
            x_in = x0 + s * run.noise
        x0, st = mech(program.denoise, x_in, run.y, s, st)
        _sync(program.device)
        times.append(time.perf_counter() - t)
    return times


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, t_start: float,
             device="cuda", cache_dir=None) -> dict:
    """Run ``cell`` for ``seconds`` from ``seed``; returns the result line's
    fields and the numbers compared."""
    cfg, tr = cell["config"], cell["traffic"]
    fam = spec.reference(cfg)
    arch = fam.arch_of(cfg["model"])
    dev = torch.device(device)
    pin = dev.type == "cuda"
    phases = {"start": time.time() - t_start}
    images = inputs.bundled_images(cache_dir or spec.ROOT / ".bench_cache")
    phases["images"] = time.time() - t_start
    w = weights_mod.make(fam.param_shapes(arch), seed, dev, cfg["precision"])
    _sync(dev)
    phases["weights"] = time.time() - t_start
    program = Program(cell, w, dev)
    del w
    _sync(dev)
    phases["model"] = time.time() - t_start
    res = arch.image_size
    batch = tr["batch"]
    steps = sampled_steps(seed, ref_fh.schedule(tr["steps"], fam.snap_grid(arch),
                                                fam.sigma_range(arch)), cell["check"]["bands"])
    captures = Captures(steps, tr["steps"], batch, (3, res, res), program.capacity, pin)
    phases["captures"] = time.time() - t_start
    run0 = inputs.Run(seed, 0, tr, images, dev, arch.image_size)
    phases["warm_calls"] = warm_up(program, run0, captures)
    phases["warm_up"] = time.time() - t_start
    norms = NormBytes(program.norms) if traced else None
    if traced:   # the profiler's first use in a process starts slowly: not in the stretch
        with torch.profiler.profile(activities=profiler_activities(pin)):
            torch.ones(1, device=dev).add_(1)
            _sync(dev)

    # -- the window --------------------------------------------------------------
    _sync(dev)
    if pin:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    boundary = Boundary(None, captures, dev)
    boundary.deadline = t0 + seconds
    boundary.sync = traced
    runs, failed, r = [], 0, 0
    while True:
        run = run0 if r == 0 else inputs.Run(seed, r, tr, images, dev, arch.image_size)
        boundary.mech = program.mechanism(run)
        captures.begin(r)
        try:
            x = program.sample(boundary, run)
        except Stop:
            break
        captures.end(x)
        failed += int((~torch.isfinite(x.reshape(batch, -1)).all(dim=1)).sum())
        if boundary.t_close is not None:   # run 0, finished after the window
            break
        runs.append(r)
        r += 1
    window_s = boundary.t_close - t0
    out = dict(window_s=window_s, setup_s=setup_s, calls=boundary.calls, runs_started=r + 1,
               runs_done=len(runs), failed=failed, batch=batch, peak_bytes=boundary.peak,
               cg_iters=boundary.cg_iters, host_syncs=boundary.host_syncs,
               call_s=boundary.call_s, capacity=program.capacity,
               calls_per_run=calls_per_run(tr["steps"]), setup_phases=phases)
    out["images_per_min"] = 60.0 * batch * (boundary.calls / out["calls_per_run"]) / window_s

    # -- the traced stretch: host and device activity over whole guided calls --------
    if traced:
        t = tr["trace"]
        prof = torch.profiler.profile(activities=profiler_activities(pin))
        stretch = Boundary(None, None, dev)
        stretch.stretches = [(t["first_call"], t["calls"], prof, "trace")]
        run = inputs.Run(seed, r + 1, tr, images, dev, arch.image_size)
        stretch.mech = program.mechanism(run)

        def on_profile(label, on):
            norms.switch(label, on)
            program.trace_denoise = on
        stretch.on_profile = on_profile
        try:
            program.sample(stretch, run)
        except Stop:
            pass
        norms.remove()
        t_read = time.perf_counter()
        out["trace"] = devtrace.read(prof, stretch.stretch_s["trace"], SPANS)
        out["trace_read_s"] = time.perf_counter() - t_read
        out["norm_bytes"] = norms.counts["trace"]
        del stretch, prof

    # -- the check -------------------------------------------------------------------
    del program, boundary, norms
    gc.collect()
    if pin:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    out["numbers"] = check(cell, seed, captures, images, arch, dev)
    out["check_s"] = time.perf_counter() - t_check
    return out


def check(cell: dict, seed: int, captures: Captures, images, arch, dev) -> Dict[str, float]:
    """The numbers compared: the program's copies of the first run's start
    and of each sampled step, judged by the reference."""
    cfg, tr = cell["config"], cell["traffic"]
    fam = spec.reference(cfg)
    p32 = weights_mod.float32(weights_mod.make(fam.param_shapes(arch), seed, dev,
                                               cfg["precision"]))
    judge = compare.Judge(fam, arch, p32, cfg["prior"], tr["steps"], cell["check"],
                          tr["mechanism"]["guidance_gradient"], seed, dev)
    nums: Dict[str, float] = {}
    run = inputs.Run(seed, 0, tr, images, dev, arch.image_size)
    if captures.started:
        nums["start"] = start_number(captures, run, judge, cfg["prior"], arch, dev)
    for st in captures.whole():
        for k, v in judge_step(judge, st, run, dev)[0].items():
            nums[k] = max(nums.get(k, 0.0), v)
    return nums


def start_number(captures: Captures, run: inputs.Run, judge: compare.Judge, prior: dict,
                 arch, dev, x0=None) -> float:
    """``start`` of the copied first call (``x0`` in place of its x: the
    control's)."""
    return compare.start(captures.x0.to(dev) if x0 is None else x0, run.noise,
                         judge.sched["sigma0"], captures.diag.to(dev),
                         prior_diag(prior, arch, dev), captures.zeros)


def prior_diag(prior: dict, arch, dev) -> torch.Tensor:
    """The covariance's initial diagonal: the first d DCT variances of a raw
    asset of the repository, as the program takes them (a smaller image
    truncates the 256 px prior; an asset shorter than d raises), or
    init_denoiser_variance (1) everywhere."""
    d = 3 * arch.image_size ** 2
    if prior["name"] == "dct_diagonal":
        name = f"dct_variance_{prior['dataset']}.npz"
        v = np.asarray(np.load(inputs.ASSETS / name)["dct_variance"], np.float32).reshape(-1)
        if v.size < d:
            raise ValueError(f"{name} holds {v.size} variances; a {arch.image_size} px "
                             f"image has {d} dimensions")
        return torch.as_tensor(v[:d], device=dev)
    return torch.ones((d,), device=dev)


def judge_step(judge: compare.Judge, st: _Step, run: inputs.Run, dev, extra=()):
    """The numbers of one sampled step of the program. ``extra``: more
    (cotangent, judged D) pairs for the reference's forward to pull back
    (a control's). Returns (numbers, the reference's denoiser before its
    clip, the extra pullbacks)."""
    i = st.i
    sigma = float(judge.sched["sigma_hat"][i])
    x_t = st.x_hat.to(dev)
    before = st.st0.before(dev)
    after = st.st1.before(dev)
    u = after.prev_u
    vjp = judge.gradient != "covariance"
    cots = ([(ref_fh.mat_of(run.op, u), after.prev_mean)] if vjp else []) + list(extra)
    with ref_fh.tf32(False):
        pre, pulls = compare.denoise_rows(judge.fam, judge.p, judge.arch, x_t, sigma,
                                          judge.rows, cots)
    out = dict(D=after.prev_mean, cov=after.cov, u=u, x0=st.d1.to(dev), pre_ref=pre,
               vjp_ref=pulls[0] if vjp else None)
    nums = judge.call(x_t, sigma, before, run.y, run.op, out)
    heun = bool(judge.sched["use_heun"][i])
    nums["heun"] = judge.heun(i, x_t, st.d1.to(dev), st.x_prime.to(dev) if heun else None,
                              st.d2.to(dev) if heun else None, st.x_next.to(dev))
    return nums, pre, pulls[1 if vjp else 0:]
