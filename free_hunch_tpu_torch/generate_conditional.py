"""Command-line entry point of the port: guided conditional generation
with evaluation.

    python -m free_hunch_tpu_torch.generate_conditional --outdir=out \\
        --dataset_path=data/imagenet/00000 --conditioning_mechanism=online_covariance ...

Counterpart of the repository root's ``generate_conditional.py``: the key
surface is ``config_default.json``'s (the JAX package's schema), and
``--conditioning_mechanism=ddnm`` runs the DDNM+ driver with the step
count doubled under the Heun solver, as the reference does for parity of
function evaluations. Rank 0 mirrors its output into ``output.log``.
Under ``torchrun --nproc_per_node=N``, ``--mesh_shape=data:1`` makes N
data-parallel ranks and ``--mesh_shape=data:N/M,model:M`` model groups of
M ranks that shard the UNet's height and Free Hunch's state
(``eval.py``). ``cmdline(argv, device=None)`` runs on the CUDA card (it raises without
one) unless ``device`` says otherwise; ``lpips_weights`` and
``fid_weights`` name the metric networks' npz files (``None``: the
flagged proxies).
"""
from __future__ import annotations

import os

from free_hunch_tpu_torch.config import load_config
from free_hunch_tpu_torch.parallel import dist, get_rank
from free_hunch_tpu_torch.utils.logging import Tee, setup_logger

logger = setup_logger()


def cmdline(argv=None, device=None, lpips_weights=None, fid_weights=None) -> dict:
    opts = load_config(argv=argv)
    os.makedirs(opts.outdir, exist_ok=True)
    if not opts.get("conditional", True):
        raise SystemExit("unconditional generation is not part of this pipeline")
    if opts.get("net") is None and opts.get("openai_state_dict_path") is None:
        raise SystemExit("specify --openai_state_dict_path (or --net)")
    kw = dict(device=device, lpips_weights=lpips_weights, fid_weights=fid_weights)

    def run():
        if opts.get("conditioning_mechanism") == "ddnm":
            from free_hunch_tpu_torch.eval_ddnm import DDNMEvaluator
            if opts.get("solver", "heun") == "heun":
                # the reference doubles the steps for the same function
                # evaluations as Heun
                opts["num_steps"] = int(opts["num_steps"]) * 2
            logger.info(f"DDNM+ sampler with {opts['num_steps']} steps")
            return DDNMEvaluator(opts, **kw).run()
        from free_hunch_tpu_torch.eval import Evaluator
        return Evaluator(opts, **kw).run()

    # the process group, when there is one, exists before the first rank query
    dist.init()

    def summarize(results):
        print(f"Time taken: {results.get('time_taken', float('nan')):.1f}s")
        print(f"PSNR: {results['psnr']}, SSIM: {results['ssim']}, LPIPS: {results['lpips']}")

    try:
        if get_rank() == 0:
            with Tee(os.path.join(opts.outdir, "output.log")):
                results = run()
                summarize(results)
        else:
            results = run()
    finally:
        dist.destroy()
    return results


if __name__ == "__main__":
    cmdline()
