"""Blind noise-level estimation (counterpart of cdlnet_tpu/nle/)."""

from cdlnet_tpu_torch.nle.mad import nle_mad
from cdlnet_tpu_torch.nle.pca import nle_pca


def noise_level(y, method="MAD"):
    """Blind sigma-hat (on the [0, 1] scale) of an (N, C, H, W) batch:
    (N, 1, 1, 1), one estimate per image.

    method: "MAD" (or True / "wvlt", as the CLIs pass it), the wavelet
    median over all of an image's channels; or "PCA", nle_pca's per-channel
    estimates averaged over the channels. The JAX package's PCA reads only
    the batch's first image (a batch gets image 0's sigma, and the framewise
    estimate of a clip fails to reshape); here each image gets its own."""
    if method in (True, "MAD", "wvlt"):
        return nle_mad(y)
    if method == "PCA":
        return nle_pca(y)[0].mean(dim=1).reshape(-1, 1, 1, 1)
    raise NotImplementedError(method)
