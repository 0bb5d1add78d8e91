"""The benchmark's plain reference: PyTorch in float32 with TF32 off.

It imports nothing of the program under test (``free_hunch_tpu_torch``)
and nothing of the JAX package. It works everything out again from the
inputs the benchmark makes: the seeded weights, the images, the noise and
the measurement. ``<family>.py`` is a denoiser family's network and
preconditioner (``adm``: the ADM UNet and the iDDPM linear grid),
``freehunch`` the guided call's stages (covariance update, CG, guidance
gradient) and the Heun update, ``operators/<name>.py`` the measurement
operators.
"""
