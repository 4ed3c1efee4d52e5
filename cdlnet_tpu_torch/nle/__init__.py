"""Blind noise-level estimation (counterpart of cdlnet_tpu/nle/)."""

from cdlnet_tpu_torch.nle.mad import nle_mad


def noise_level(y, method="MAD"):
    """Blind sigma-hat (on the [0, 1] scale) of an (N, C, H, W) batch:
    (N, 1, 1, 1). `method` is "MAD" (or True / "wvlt", as the CLIs pass it);
    the PCA estimator is not ported yet."""
    if method in (True, "MAD", "wvlt"):
        return nle_mad(y)
    if method == "PCA":
        raise NotImplementedError(
            "the PCA noise-level estimator is not ported to cdlnet_tpu_torch "
            "yet (see ROADMAP.md)")
    raise NotImplementedError(method)
