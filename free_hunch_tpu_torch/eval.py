"""Conditional-generation evaluation driver.

Counterpart of ``free_hunch_tpu/eval.py``: the dataset sharded over
processes, batches of ``batch_size`` images x len(seeds) samples, operator
and noise assembly, sampling, PSNR/SSIM/LPIPS (and FID against reference
statistics), the resume journal, results.txt / results.json, image and
video output, and pruning of excess images.

Where the JAX driver jits one batch function, this one calls
``samplers/edm.py::sample_loop`` (or the DDNM+ sampler, ``eval_ddnm.py``)
eagerly on the device, under ``torch.no_grad`` (the mechanisms enable
gradients where they pull back through the UNet). Every random draw comes
from a CPU ``torch.Generator`` whose seed is a pure function of (seed, rank,
purpose, counter) (``Evaluator._generator``), the structure of the JAX
driver's folded keys: initial noise per seed, a mask per image, and per
batch one generator for the measurement noise and one for the sampler.
Draws are made on the CPU and copied to the device, so a resumed run draws
what an uninterrupted one does, and a run on the card what the same run on
the CPU does; the numbers differ from the JAX package's draws.

Data-parallel over processes, as the JAX driver is: each rank of the
process group (``parallel/dist.py``; ``torchrun --nproc_per_node=N``)
computes on its own card the images ``shard_indices`` strides to it, and
the totals are gathered at the end: the sample-weighted metric means
(``_process_mean``), the image and resumed-batch counts (``_process_sum``)
and the FID moments (``metrics/fid.py::allgather_merge``). Rank 0 writes
``results.txt`` and ``results.json``; each data group keeps its own
journal.

``mesh_shape=data:N,model:M`` with M > 1 (JAX ``eval.py:104-138``, ``:220``)
splits the world into N model groups of M ranks
(``parallel/mesh.py::make_model_groups``): the images are strided over the
groups and every draw is keyed on the group's data index, so the ranks of
a group hold the same batch, noise and masks; the UNet shards its height
and Free Hunch its state's d over the group (the JAX driver's
``spatial_partition`` and ``cov_partition``; here the group itself). The
group's model rank 0 writes its PNGs and journal and counts its images
and FID features in the totals; on resume every rank of the group replays
that journal. DDNM+ does not take a model axis (it
bypasses the covariance, and the JAX driver never partitions it), nor
does the int8 torso: both raise (ROADMAP item 15b).

Fault injection, for the kill-and-resume tests: with the option
``fault_kill_after_batches=k`` and the environment variable
``FREE_HUNCH_FAULT_INJECT=1`` both set, the process SIGKILLs itself after
its k-th computed batch, once that batch's images and journal record are
on disk. Either gate alone does nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import signal
import time
from typing import Any, Optional

import numpy as np
import torch

from free_hunch_tpu_torch import randn
from free_hunch_tpu_torch.data import png
from free_hunch_tpu_torch.data.dataset import shard_indices
from free_hunch_tpu_torch.data.encoders import StandardRGBEncoder
from free_hunch_tpu_torch.guidance import choose_conditioning_mechanism
from free_hunch_tpu_torch.metrics.quality import lpips_fn, psnr, ssim
from free_hunch_tpu_torch.models.loading import load_model, wrap_precond
from free_hunch_tpu_torch.models.precond import PRECONDS
from free_hunch_tpu_torch.operators import get_operator
from free_hunch_tpu_torch.operators import masks as mask_mod
from free_hunch_tpu_torch.parallel import dist, get_rank, get_world_size
from free_hunch_tpu_torch.parallel.mesh import ITEM_15B, make_model_groups
from free_hunch_tpu_torch.samplers.edm import (prepare_schedule, required_cov_capacity,
                                               sample_loop)
from free_hunch_tpu_torch.utils.dynamic import construct_class_by_name
from free_hunch_tpu_torch.utils.logging import setup_logger

logger = setup_logger()

_SCHEDULE_KEYS = ("num_steps", "sigma_min", "sigma_max", "rho", "solver",
                  "discretization", "schedule", "scaling", "S_churn", "S_min",
                  "S_max", "S_noise")
# the JAX package also passes max_vector_count, a FreeHunch field nothing reads
_MECH_KEYS = dict(
    online_covariance=("image_base_covariance", "denoiser_mean_error_threshold",
                       "use_analytical_score_time_update", "project_to_diagonal",
                       "space_step_update_threshold",
                       "space_step_update_lower_threshold", "do_space_updates",
                       "use_analytic_var_at_end", "solver_type", "cg_coords",
                       "cg_warm_start", "guidance_gradient", "guidance_vjp_below",
                       "bfgs_secant_novelty_min"),
    diffpir=("diffpir_lambda",),
)
_PURPOSES = ("mask", "measure", "sample", "calibrate")


def build_operator_kwargs(opts) -> dict:
    """CLI options -> operator kwargs."""
    res = opts.get("img_resolution", 256)
    kw = dict(name=opts["operator_name"], kernel_size=opts.get("kernel_size", 61),
              intensity=opts.get("intensity", 1.0),
              sigma_s=opts.get("noise_sigma", 0.1),
              scale_factor=opts.get("scale_factor", 2),
              in_shape=(1, 3, res, res))
    itype = opts.get("inpainting_type", "random")
    if itype == "box":
        kw["mask_opt"] = {"mask_type": "box", "mask_len_range": (64, 156),
                          "mask_prob_range": (0.1, 0.3), "image_size": res}
    elif itype == "random":
        kw["mask_opt"] = {"mask_type": "random", "mask_len_range": (64, 156),
                          "mask_prob_range": (opts.get("inpainting_prob_lower", 0.1),
                                              opts.get("inpainting_prob_upper", 0.3)),
                          "image_size": res}
    else:
        raise ValueError(f"Inpainting type {itype} is not supported")
    return kw


@dataclasses.dataclass
class Evaluator:
    """The driver. ``device`` (default: the rank's own card,
    ``parallel/dist.py::rank_device``, which raises without one) and the
    metric networks' weight files (``lpips_weights``,
    ``fid_weights``: the JAX package's npz files; ``None`` takes the
    flagged proxies) are Python arguments: the config schema stays the JAX
    package's."""
    opts: dict
    device: Any = None
    lpips_weights: Optional[str] = None
    fid_weights: Optional[str] = None

    def __post_init__(self):
        opts = self.opts
        dist.init()
        self.rank, self.world = get_rank(), get_world_size()
        self.mg = make_model_groups(opts.get("mesh_shape"), self.world, self.rank)
        # the rank that writes its group's images and journal, and whose
        # images and features count in the totals
        self.writer = self.mg.model_index == 0
        if self.mg.sharded and opts.get("conditioning_mechanism") == "ddnm":
            raise ValueError(f"mesh_shape={opts.get('mesh_shape')!r}: DDNM+ takes no model "
                             f"axis (it bypasses the covariance; the JAX driver never "
                             f"partitions it); {ITEM_15B}")
        self.device = dist.rank_device(self.device)
        self.seed = int(opts.get("seed", 0))

        # --- model ----------------------------------------------------------
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            opts.get("dtype", "bfloat16")]
        remat = bool(opts.get("remat", False))
        if opts.get("guidance_gradient") == "hybrid" and not remat:
            # as in the JAX driver, where hybrid without remat keeps every
            # forward activation as a pullback residual
            logger.warning("guidance_gradient=hybrid forces remat=True")
            remat = True
        quant = opts.get("quant", "none")
        quant = None if quant in (None, "none", "") else quant
        self._quant = quant
        self.model, model_args = load_model(
            opts.get("openai_state_dict_path"), opts["openai_setup_path"], dtype=dtype,
            remat=remat, init_random_if_missing=bool(opts.get("allow_random_init", False)),
            device=self.device, quant=quant, model_group=self.mg)
        self._model_args = model_args
        self._precond_kind = opts.get("iddpm_preconditioning", "linear")
        self.res = model_args.get("image_size", 256)
        if quant == "int8_static":
            # the schedule needs only the sigma grid; the static torso runs
            # after its calibration below installs the scales
            if self._precond_kind not in PRECONDS:
                raise ValueError(f"unknown preconditioner {self._precond_kind!r}")
            self.precond = PRECONDS[self._precond_kind](
                self.model, img_resolution=self.res, img_channels=3,
                label_dim=1000 if model_args.get("class_cond") else 0, qscales=None)
        else:
            self.precond = wrap_precond(self.model, model_args, self._precond_kind)
        self.encoder = StandardRGBEncoder()

        # --- dataset ----------------------------------------------------------
        ds_name = opts.get("dataset_name") or \
            "free_hunch_tpu_torch.data.dataset.ImageFolderDataset"
        # class-conditional checkpoints need the dataset.json labels
        self.dataset = construct_class_by_name(
            class_name=ds_name, path=opts["dataset_path"], resolution=self.res,
            return_idx=True, use_labels=bool(model_args.get("class_cond")))
        total = opts.get("total_images") or len(self.dataset)
        total = min(total, len(self.dataset))
        self.indices = shard_indices(total, self.mg.data_size, self.mg.data_index)
        self.seeds = list(opts.get("seeds", [0]))
        self.batch_size = max(int(opts.get("batch_size", 1)), 1)
        self.save_videos = bool(opts.get("save_videos", False))

        # --- schedule + operator + mechanism ---------------------------------
        sched_kw = {k: opts[k] for k in _SCHEDULE_KEYS if k in opts and opts[k] is not None}
        if sched_kw.get("S_max") in ("inf", float("inf")):
            sched_kw["S_max"] = float("inf")
        self.xs, self.sigma0_scaled = prepare_schedule(
            round_sigma=self.precond.round_sigma, net_sigma_min=self.precond.sigma_min,
            net_sigma_max=self.precond.sigma_max, **sched_kw)

        self.operator_kwargs = build_operator_kwargs(dict(opts, img_resolution=self.res))
        self.is_inpainting = opts["operator_name"] == "inpainting"
        self._template_op = get_operator(**self.operator_kwargs, device=self.device,
                                         mask_generator=torch.Generator().manual_seed(0))

        mech_name = opts.get("conditioning_mechanism", "dps")
        self._mech_builder = None
        if mech_name != "ddnm":
            # ddnm has no conditioning mechanism: eval_ddnm.DDNMEvaluator
            # supplies its own batch function
            self._mech_builder = self._mechanism_builder(mech_name)
        if self._quant == "int8_static":
            self._calibrate_static_qscales()
        self._install_codecs()
        self._lpips = lpips_fn("vgg", weights_path=self.lpips_weights, device=self.device)
        self._install_fid()

    def _mechanism_builder(self, mech_name: str):
        opts = self.opts
        mech_cls = choose_conditioning_mechanism(mech_name)
        mkw = dict(cond_scaling=opts.get("cond_scaling", 1.0),
                   clip_x0_mean=bool(opts.get("clip_x0_mean", False)),
                   pigdm_posthoc_scaling=bool(opts.get("pigdm_posthoc_scaling", False)),
                   max_rtol=opts.get("max_rtol", 1.0),
                   use_rtol_func=bool(opts.get("use_rtol_func", False)),
                   cg_maxiter=opts.get("cg_maxiter"))
        for k in _MECH_KEYS.get(mech_name, ()):
            if k in opts:
                mkw[k] = opts[k]
        if mech_name == "online_covariance":
            mkw.update(transport_mean_bound=opts.get("transport_mean_bound"),
                       guidance_update_bound=opts.get("guidance_update_bound"),
                       model_group=self.mg,
                       init_denoiser_variance=1.0,
                       init_noise_variance=float(self.sigma0_scaled) ** 2,
                       data_dim=3 * self.res * self.res,
                       cov_capacity=self._cov_capacity(opts),
                       data_dir=opts.get("dataset_path"))
        return lambda op: mech_cls(forward_operator=op, **mkw)

    def _generator(self, purpose: str, counter: int) -> torch.Generator:
        """A CPU generator seeded by a pure function of (seed, data index,
        purpose, counter): the counterpart of the JAX driver's folded keys.
        The data index is the rank's without a model axis; the ranks of a
        model group share it, and so draw alike."""
        tag = (f"{self.seed}/{self.mg.data_index}/{_PURPOSES.index(purpose)}/"
               f"{int(counter)}")
        s = int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8], "little") >> 1
        return torch.Generator().manual_seed(s)

    def _calibrate_static_qscales(self):
        """quant='int8_static': build (or load) the per-(site, sigma-stage)
        activation-scale table (``models/calibrate.py``) by replaying the
        sampler on synthetic batches, and install the static preconditioner.
        The table is cached beside the checkpoint, keyed by architecture,
        schedule, operator and margin."""
        from free_hunch_tpu_torch.models import calibrate as cal
        opts = self.opts
        if self._mech_builder is None:
            raise ValueError("quant='int8_static' is not supported for the ddnm driver; "
                             "use quant='int8' there")
        margin = float(opts.get("qscale_margin", 1.1))
        n_draws = int(opts.get("qscale_calib_draws", 3))
        ckpt = opts.get("openai_state_dict_path") or "qscales"
        tag = self.operator_kwargs["name"]
        cache = cal.qscales_cache_key(ckpt, self._model_args, self.xs, self.res, margin,
                                      tag) + (f".d{n_draws}" if n_draws != 1 else "")
        qs = cal.load_qscales(cache)
        if qs is None:
            logger.info(f"calibrating int8_static activation scales ({n_draws} "
                        f"dynamic-int8 sampler replays)...")
            op = self._template_op
            shape = (self.batch_size, 3, self.res, self.res)
            state = self.model.state_dict()
            for d in range(n_draws):
                gen = self._generator("calibrate", d)
                cond = (torch.rand(shape, generator=gen) * 2 - 1).to(self.device)
                with torch.no_grad():
                    y = op.forward(cond, noiseless=False, generator=gen)
                noise = randn(shape, gen, device=self.device)
                t = cal.calibrate_qscales(
                    self._model_args, state, self._mech_builder(op), noise, y, self.xs,
                    self.sigma0_scaled, gen, dtype=self.model.cfg.dtype, margin=margin,
                    precond_kind=self._precond_kind, device=self.device)
                qs = t if qs is None else cal.merge_qscales(qs, t)
            try:
                cal.save_qscales(cache, *qs)
            except OSError:
                pass
        self.precond = wrap_precond(self.model, self._model_args, self._precond_kind,
                                    qscales=qs)

    def _install_fid(self):
        """FID against precomputed reference statistics (``--fid_ref_stats``,
        an npz of ``fid.FeatureStats.save``); a missing file, or statistics
        of the other feature network (proxy against real), raise."""
        self._fid = None
        path = self.opts.get("fid_ref_stats")
        if not path:
            return
        if not os.path.exists(path):
            raise FileNotFoundError(f"--fid_ref_stats={path} does not exist (save "
                                    f"metrics/fid.py::FeatureStats of the reference images)")
        from free_hunch_tpu_torch.metrics import fid as fid_mod
        extract, is_proxy = fid_mod.make_extractor(self.fid_weights, device=self.device)
        with np.load(path) as ref_blob:
            ref_proxy = bool(ref_blob["is_proxy"]) if "is_proxy" in ref_blob else None
        if ref_proxy is not None and ref_proxy != is_proxy:
            raise ValueError(
                f"--fid_ref_stats={path} was computed with "
                f"{'the proxy' if ref_proxy else 'real'} Inception features but this run "
                f"uses {'the proxy' if is_proxy else 'real'} ones: rebuild the statistics "
                f"with the same weights")
        self._fid = dict(mod=fid_mod, extract=extract, is_proxy=is_proxy,
                         stats=fid_mod.FeatureStats(), ref=path)
        if is_proxy:
            logger.warning("no FID weights given: FID uses deterministic random Inception "
                           "features (fid_is_proxy=true; not comparable to published "
                           "numbers)")

    def _fid_add_u8(self, images_u8):
        x = torch.as_tensor(np.asarray(images_u8), device=self.device).float() / 127.5 - 1.0
        self._fid["stats"].add(self._fid["extract"](x))

    def _fid_replay_ok(self, outdir: str, batch_id: str) -> bool:
        """On resume, FID features of journaled batches are re-extracted
        from the saved PNGs (journals hold only scalar means). False, which
        forces a recomputation, when an image is missing (e.g. pruned)."""
        if self._fid is None:
            return True
        paths = [os.path.join(outdir, "images", f"{n}.png") for n in batch_id.split("|")]
        if not all(os.path.exists(p) for p in paths):
            return False
        if self.writer:
            self._fid_add_u8(np.stack([png.read_png(p).transpose(2, 0, 1) for p in paths]))
        return True

    def _cov_capacity(self, opts) -> int:
        """'auto' (default): the schedule's exact capacity
        (``samplers.edm.required_cov_capacity``); an integer pins it."""
        cap = opts.get("cov_capacity", "auto")
        if cap in (None, "auto", 0, "0"):
            return required_cov_capacity(
                self.xs, lower=float(opts.get("space_step_update_lower_threshold", 1.0)),
                upper=float(opts.get("space_step_update_threshold", 10.0)),
                do_space_updates=bool(opts.get("do_space_updates", True)))
        return int(cap)

    def _install_codecs(self):
        self._decode = self.encoder.decode
        self._encode = self.encoder.encode

    def _gen_noise(self, seeds) -> torch.Tensor:
        """Initial noise per seed, as the JAX driver draws it from
        PRNGKey(seed): one (3, res, res) draw per entry of ``seeds``, from a
        CPU generator seeded by it."""
        return torch.stack([randn((3, self.res, self.res), torch.Generator().manual_seed(int(s)),
                                  device=self.device) for s in seeds])

    def _gen_masks(self, gidx) -> torch.Tensor:
        """A fresh inpainting mask per image index, (b, C, H, W) on the
        device, drawn from a CPU generator per image."""
        opt = dict(self.operator_kwargs["mask_opt"])
        return torch.cat([mask_mod.generate_mask(self._generator("mask", g), opt, 3)
                          for g in gidx]).to(self.device)

    # -- the per-batch function ------------------------------------------------

    def _batch_fn(self, noise, cond_latents, operator, gens, labels=None):
        """(x, trajectory or None, y): measure with ``gens[0]``, sample with
        ``gens[1]``."""
        denoise = lambda x, s: self.precond(x, s, y=labels)  # noqa: E731
        mech = self._mech_builder(operator)
        y = operator.forward(cond_latents, noiseless=False, generator=gens[0])
        x, traj = sample_loop(denoise, mech, noise, y, self.xs, gens[1],
                              sigma0_scaled=self.sigma0_scaled,
                              return_trajectory=self.save_videos)
        return x, (traj if self.save_videos else None), y

    def _make_operator(self, gidx):
        """A fresh random mask per image for inpainting, shared by its seed
        replicas; the shared operator otherwise."""
        if not self.is_inpainting:
            return self._template_op
        mask = torch.repeat_interleave(self._gen_masks(gidx), len(self.seeds), dim=0)
        return get_operator(**self.operator_kwargs, mask=mask, device=self.device)

    # -- main loop ---------------------------------------------------------------

    def run(self) -> dict:
        opts = self.opts
        outdir = opts["outdir"]
        os.makedirs(outdir, exist_ok=True)
        if self.rank == 0:
            with open(os.path.join(outdir, "config.json"), "w") as f:
                json.dump({k: v for k, v in sorted(dict(opts).items())
                           if isinstance(v, (str, int, float, bool, list, tuple,
                                             type(None)))}, f, indent=2)
        n_seeds = len(self.seeds)
        acc = MetricAccumulator("psnr", "ssim", "lpips")
        n_batches = 0
        n_resumed = 0
        t0 = time.time()

        # resume: each data group's writer journals its completed batches,
        # after their images are saved; --resume=true replays the records
        # (on every rank of the group) instead of recomputing, and skipped
        # batches advance n_batches like computed ones, so every later draw
        # stays aligned
        journal_path = os.path.join(outdir, f"metrics_rank{self.mg.data_index:02d}.jsonl")
        resume = bool(opts.get("resume", False))
        done = {}
        if resume and os.path.exists(journal_path):
            with open(journal_path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                        done[rec["batch"]] = rec
                    except (ValueError, KeyError):
                        pass  # truncated tail record from a crash
        journal_file = (open(journal_path, "a" if resume else "w") if self.writer
                        else contextlib.nullcontext())
        with journal_file as journal, torch.no_grad():
            for start in range(0, len(self.indices), self.batch_size):
                idx_chunk = self.indices[start:start + self.batch_size]
                gidx = [int(i) for i in idx_chunk]
                batch_id = "|".join(f"{g:06d}_{s:06d}" for g in gidx for s in self.seeds)
                if batch_id in done and self._fid_replay_ok(outdir, batch_id):
                    rec = done[batch_id]
                    acc.add(int(rec["n"]), psnr=rec["psnr"], ssim=rec["ssim"],
                            lpips=rec["lpips"])
                    n_batches += 1
                    n_resumed += 1
                    logger.info(f"batch {n_batches}: resumed from journal "
                                f"(psnr={rec['psnr']:.3f})")
                    continue
                imgs, labs = [], []
                for i in idx_chunk:
                    _, img, lab = self.dataset[int(i)]
                    imgs.append(img)
                    labs.append(lab)
                cond_rep = np.repeat(np.stack(imgs), n_seeds, axis=0)  # (b, C, H, W) u8
                cond_latents = self._encode(torch.as_tensor(cond_rep, device=self.device))
                labels = None
                if getattr(self.precond, "label_dim", 0) and np.size(labs[0]):
                    labels = torch.as_tensor(np.repeat(np.argmax(np.stack(labs), axis=-1),
                                                       n_seeds), device=self.device)
                noise = self._gen_noise([int(s) % (1 << 31) for g in gidx
                                         for s in self.seeds])
                op = self._make_operator(gidx)
                gens = (self._generator("measure", n_batches),
                        self._generator("sample", n_batches))
                x, traj, y = self._batch_fn(noise, cond_latents, op, gens, labels)

                gen_dev = self._decode(x)
                gen_u8 = gen_dev.cpu().numpy()
                y_u8 = self._decode(y).cpu().numpy()

                names = [f"{g:06d}_{s:06d}.png" for g in gidx for s in self.seeds]
                if self.writer and opts.get("save_images", True):
                    _save_images(gen_u8, os.path.join(outdir, "images"), names)
                if self.writer and opts.get("num_other_images_to_save", 0) > 0:
                    _save_images(cond_rep, os.path.join(outdir, "cond_images"), names)
                    _save_images(y_u8, os.path.join(outdir, "forward_images"), names)
                if self.writer and self.save_videos and traj is not None:
                    frames = self._decode(traj.reshape((-1,) + tuple(traj.shape[2:])))
                    frames = frames.cpu().numpy().reshape(
                        (traj.shape[0], -1) + tuple(frames.shape[1:]))
                    _save_videos(list(frames), os.path.join(outdir, "videos"), names)

                ref_f = torch.as_tensor(cond_rep, device=self.device).float()
                gen_f = gen_dev.float()
                p = float(torch.mean(psnr(ref_f, gen_f)))
                s = float(torch.mean(ssim(ref_f, gen_f)))
                lp = self._lpips(ref_f / 127.5 - 1, gen_f / 127.5 - 1)
                if self._fid is not None and self.writer:
                    self._fid_add_u8(gen_u8)
                acc.add(gen_u8.shape[0], psnr=p, ssim=s, lpips=lp)
                if self.writer and batch_id not in done:  # one record per batch
                    journal.write(json.dumps(dict(batch=batch_id, n=int(gen_u8.shape[0]),
                                                  psnr=p, ssim=s, lpips=float(lp))) + "\n")
                    journal.flush()
                n_batches += 1
                logger.info(f"batch {n_batches}: psnr={p:.3f} ssim={s:.4f} lpips={lp:.4f}")
                kill_after = (opts.get("fault_kill_after_batches")
                              if os.environ.get("FREE_HUNCH_FAULT_INJECT") == "1" else None)
                if kill_after is not None and 0 < int(kill_after) <= n_batches - n_resumed:
                    # a hard crash once this batch's images and journal
                    # record are on disk: a restart with --resume=true
                    # replays the journal and recomputes the rest
                    if self.writer:
                        journal.close()
                    logger.warning(f"fault injection: SIGKILL after {kill_after} computed "
                                   f"batches")
                    os.kill(os.getpid(), signal.SIGKILL)

        elapsed = time.time() - t0
        # each image counts once: on its group's writer
        mine = int(self.writer)
        totals = _process_mean(acc.means(), acc.count * mine)
        totals["time_taken"] = elapsed
        totals["images"] = _process_sum(len(self.indices) * n_seeds * mine)
        totals["resumed_batches"] = _process_sum(n_resumed * mine)
        totals["lpips_is_proxy"] = bool(self._lpips.is_proxy)
        if self._fid is not None:
            st = self._fid["mod"].allgather_merge(self._fid["stats"])
            if st.n >= 2:
                # the extractor and the reference were checked to agree on proxy
                totals["fid"] = self._fid["mod"].compute_fid(st, self._fid["ref"])
                totals["fid_is_proxy"] = bool(self._fid["is_proxy"])

        if self.rank == 0:
            with open(os.path.join(outdir, "results.txt"), "w") as f:
                f.write(f"PSNR: {totals['psnr']}\n")
                f.write(f"SSIM: {totals['ssim']}\n")
                f.write(f"LPIPS: {totals['lpips']}\n")
                if "fid" in totals:
                    f.write(f"FID: {totals['fid']}\n")
            with open(os.path.join(outdir, "results.json"), "w") as f:
                json.dump(totals, f, indent=2)
            _prune_images(outdir, opts.get("num_other_images_to_save"))
        return totals


class MetricAccumulator:
    """Sample-weighted running mean of named metrics: per-batch means are
    weighted by batch size, so a ragged last batch does not bias the
    result."""

    def __init__(self, *names: str):
        self.sums = {n: 0.0 for n in names}
        self.count = 0

    def add(self, batch_size: int, **batch_means: float):
        for n, v in batch_means.items():
            self.sums[n] += float(v) * batch_size
        self.count += batch_size

    def means(self) -> dict:
        d = max(self.count, 1)
        return {n: s / d for n, s in self.sums.items()}


def _process_sum(n: int) -> int:
    """A rank-local integer summed over the process group."""
    return int(dist.all_gather(np.asarray([n], np.int64)).sum())


def _process_mean(means: dict, n_samples: int) -> dict:
    """Sample-weighted metric means over the process group: each rank's
    (mean x count, count) gathered, summed and divided once, so unequal
    shards weigh by their samples."""
    n = float(n_samples)
    arr = np.asarray([means["psnr"] * n, means["ssim"] * n, means["lpips"] * n, n])
    gathered = dist.all_gather(arr)
    if gathered.shape[0] == 1:
        return dict(means)
    sums = gathered[:, :3].sum(axis=0)
    count = max(gathered[:, 3].sum(), 1.0)
    return dict(means, psnr=float(sums[0] / count), ssim=float(sums[1] / count),
                lpips=float(sums[2] / count))


def _save_images(images_u8: np.ndarray, image_dir: str, names) -> None:
    os.makedirs(image_dir, exist_ok=True)
    for img, name in zip(images_u8, names):
        png.write_png(os.path.join(image_dir, name), np.ascontiguousarray(img.transpose(1, 2, 0)))


def _save_videos(frames_list, video_dir: str, names) -> None:
    """mp4 of the sampling trajectory per sample, one frame per step (needs
    OpenCV, imported here only)."""
    import cv2
    os.makedirs(video_dir, exist_ok=True)
    n = frames_list[0].shape[0]
    for i in range(n):
        path = os.path.join(video_dir, names[i].replace(".png", ".mp4"))
        h, w = frames_list[0][i].shape[-2:]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
        for frames in frames_list:
            im = np.ascontiguousarray(frames[i].transpose(1, 2, 0))
            vw.write(cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
        vw.release()


def _prune_images(outdir: str, keep: Optional[int]) -> None:
    """Delete the PNGs beyond the first ``keep`` of each image directory."""
    if keep is None or keep < 0:
        return
    for sub in ("images", "cond_images", "forward_images"):
        d = os.path.join(outdir, sub)
        if not os.path.isdir(d):
            continue
        files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
        for f in files[keep:]:
            os.remove(os.path.join(d, f))
