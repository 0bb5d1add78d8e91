"""The card's machine has no PIL, no PyYAML, no OpenCV and no diffusers. In
a fresh interpreter where importing any of them fails, the port's driver
modules (and the multi-process runtime, the SD-VAE, the oracles and the
tools) import, a bundled PNG reads through the dataset at its own 256 px, an
image saves through the driver's writer and the config loads; only a
resize, which needs PIL, raises ``ImportError`` and says why."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("PIL", "PIL.Image", "yaml", "cv2", "diffusers"):
        sys.modules[name] = None          # any import of it raises ImportError
    import numpy as np
    import free_hunch_tpu_torch.generate_conditional
    import free_hunch_tpu_torch.eval as ev
    import free_hunch_tpu_torch.eval_ddnm
    import free_hunch_tpu_torch.metrics.fid
    import free_hunch_tpu_torch.metrics.lpips
    import free_hunch_tpu_torch.metrics.quality
    import free_hunch_tpu_torch.parallel.mesh
    import free_hunch_tpu_torch.utils.stats
    import free_hunch_tpu_torch.utils.profiling
    import free_hunch_tpu_torch.analysis.gmm_guided
    import free_hunch_tpu_torch.analysis.linear_gaussian
    import free_hunch_tpu_torch.tools.count_flops
    import free_hunch_tpu_torch.tools.dataset_tool
    import free_hunch_tpu_torch.tools.frequency_analysis
    import free_hunch_tpu_torch.tools.image_visualisation
    import free_hunch_tpu_torch.tools.compute_fid_stats
    from free_hunch_tpu_torch.data.encoders import StabilityVAEEncoder
    from free_hunch_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from free_hunch_tpu_torch.config import load_config
    from free_hunch_tpu_torch.data import png
    from free_hunch_tpu_torch.data.dataset import ImageFolderDataset

    out = sys.argv[1]
    ds = ImageFolderDataset("data/imagenet/00000", resolution=256, return_idx=True)
    idx, img, label = ds[3]
    assert idx == 3 and img.shape == (3, 256, 256) and img.dtype == np.uint8
    ev._save_images(img[None], out, ["x.png"])
    assert np.array_equal(png.read_png(out + "/x.png").transpose(2, 0, 1), img)
    opts = load_config(argv=["--outdir=" + out, "--num_steps=5"])
    assert opts.num_steps == 5 and opts.operator_name == "gaussian_blur"
    try:
        ImageFolderDataset("data/imagenet/00000", resolution=32)[0]
    except ImportError as e:
        assert "PIL is needed to resize" in str(e), e
    else:
        raise AssertionError("a resize without PIL did not raise")
    enc = StabilityVAEEncoder(cfg=VAEConfig(block_out_channels=(32,), layers_per_block=1,
                                            norm_num_groups=8))
    enc.init(device="cpu", params=AutoencoderKL(enc.cfg).state_dict())
    assert tuple(enc.encode_pixels(np.zeros((1, 3, 8, 8), np.uint8)).shape) == (1, 8, 8, 8)
    for name in ("PIL", "yaml", "cv2", "diffusers"):
        assert sys.modules[name] is None
    print("OK")
""")


def test_the_driver_runs_without_pil_yaml_or_cv2(tmp_path):
    r = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")
