"""Color matching of a window's frames to an anchor frame: histogram match ->
Monge-Kantorovich linear transfer -> histogram match ('hm-mkl-hm').

Counterpart of `controlanimate_tpu/ops/color_match.py`, in plain PyTorch
tensor code (the JAX module has no Pallas kernel):
  * `match_colors_u8`, the device path the stitch runs: 256-level LUT
    histogram matching (the frames' CDFs estimated on every 4th pixel above
    65,536 pixels, the anchor's exact), and the MKL transfer with
    Newton-Schulz matrix square roots (14 iterations, fp32, eps 1e-6);
  * `match_colors` / `hist_match` / `mkl_transfer`, the exact form (rank
    histogram matching, eigendecomposition square roots) on [0, 1] floats.
The JAX module replaces the LUT gather by one-hot matmuls (`_lut_apply`), a
TPU workaround for slow gathers; here the LUT is indexed directly, which is
exact for an integer LUT.
"""

from __future__ import annotations

import torch

_CDF_STRIDE = 4  # frames of >= 65,536 pixels estimate their CDF on every 4th pixel
_NS_ITERS = 14


# -- exact form --------------------------------------------------------------
def _hist_match_channel(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Exact histogram matching of flat channels (..., N) to a reference
    channel (N,): rank -> reference quantile."""
    order = torch.argsort(src, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return torch.sort(ref).values[ranks]


def hist_match(image: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) matched channel-wise to ref (H, W, C)."""
    H, W, C = image.shape[-3:]
    flat = image.reshape(-1, H * W, C)
    ref_flat = ref.reshape(H * W, C)
    out = torch.stack(
        [_hist_match_channel(flat[..., c], ref_flat[:, c]) for c in range(C)], dim=-1)
    return out.reshape(image.shape)


def _sqrtm_psd(m: torch.Tensor) -> torch.Tensor:
    w, v = torch.linalg.eigh(m)
    w = torch.clamp(w, min=1e-10)
    return (v * torch.sqrt(w)[None, :]) @ v.T


def mkl_transfer(image: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Monge-Kantorovich linear color transfer (Pitie & Kokaram 2007):
    x' = (x - mu_s) @ A + mu_r with
    A = C_s^{-1/2} (C_s^{1/2} C_r C_s^{1/2})^{1/2} C_s^{-1/2}."""
    src = image.reshape(-1, 3).float()
    dst = ref.reshape(-1, 3).float()
    mu_s, mu_r = src.mean(0), dst.mean(0)
    xs, xr = src - mu_s, dst - mu_r
    eye = torch.eye(3, dtype=torch.float32, device=image.device)
    cov_s = xs.T @ xs / xs.shape[0] + 1e-8 * eye
    cov_r = xr.T @ xr / xr.shape[0] + 1e-8 * eye
    cs_half = _sqrtm_psd(cov_s)
    w, v = torch.linalg.eigh(cov_s)
    w = torch.clamp(w, min=1e-10)
    cs_inv_half = (v * (1.0 / torch.sqrt(w))[None, :]) @ v.T
    middle = _sqrtm_psd(cs_half @ cov_r @ cs_half)
    A = cs_inv_half @ middle @ cs_inv_half
    return (xs @ A + mu_r).reshape(image.shape)


def match_colors(frames: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """hm -> mkl -> hm. frames: (F, H, W, 3) floats in [0, 1]; ref (H, W, 3)."""
    frames, ref = frames.float(), ref.float()
    x = hist_match(frames, ref)
    x = torch.stack([mkl_transfer(f, ref) for f in x])
    x = hist_match(x, ref)
    return torch.clamp(x, 0.0, 1.0)


# -- device path on uint8 ------------------------------------------------------
def _cdf256(x: torch.Tensor) -> torch.Tensor:
    """(G, N) integer levels in [0, 256) -> (G, 256) fp32 CDFs,
    cdf[g, l] = mean(x[g] <= l)."""
    G, n = x.shape
    offsets = torch.arange(G, device=x.device)[:, None] * 256
    counts = torch.bincount((x + offsets).reshape(-1), minlength=G * 256)
    return counts.reshape(G, 256).cumsum(dim=1).float() / n


def _ref_cdfs(ref_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 -> (3, 256) exact per-channel CDFs."""
    return _cdf256(ref_u8.reshape(-1, 3).long().T)


def _hist_match_u8(image_u8: torch.Tensor, cdf_ref: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) uint8 matched per frame and channel to the reference
    CDFs (3, 256): lut = clip(searchsorted(cdf_ref, cdf_frame), 0, 255)."""
    F, H, W, C = image_u8.shape
    flat = image_u8.reshape(F, H * W, C).long()
    stride = _CDF_STRIDE if H * W >= 1 << 16 else 1
    cdf_s = _cdf256(flat[:, ::stride].permute(0, 2, 1).reshape(F * C, -1)).reshape(F, C, 256)
    lut = torch.searchsorted(cdf_ref.expand(F, C, 256).contiguous(), cdf_s)
    lut = torch.clamp(lut, 0, 255).to(torch.uint8)  # (F, C, 256)
    return torch.gather(lut.permute(0, 2, 1), 1, flat).reshape(image_u8.shape)


def _sqrtm_ns(a: torch.Tensor, iters: int = _NS_ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """(A^{1/2}, A^{-1/2}) of PSD matrices (..., n, n) by Newton-Schulz
    iteration: matrix products only."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    norm = torch.sqrt(torch.sum(torch.square(a), dim=(-2, -1), keepdim=True)) + 1e-12
    y, z = a / norm, eye.expand_as(a)
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    s = torch.sqrt(norm)
    return y * s, z / s


def _mkl_transfer_ns(images: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """MKL transfer of each of (F, H, W, 3) fp32 frames to ref (H, W, 3)
    with Newton-Schulz square roots."""
    F = images.shape[0]
    src = images.reshape(F, -1, 3)
    dst = ref.reshape(-1, 3)
    mu_s, mu_r = src.mean(1, keepdim=True), dst.mean(0)
    xs, xr = src - mu_s, dst - mu_r
    eye = torch.eye(3, dtype=torch.float32, device=images.device)
    cov_s = xs.transpose(1, 2) @ xs / xs.shape[1] + 1e-6 * eye
    cov_r = xr.T @ xr / xr.shape[0] + 1e-6 * eye
    cs_half, cs_inv_half = _sqrtm_ns(cov_s)
    middle, _ = _sqrtm_ns(cs_half @ cov_r @ cs_half)
    A = cs_inv_half @ middle @ cs_inv_half
    return (xs @ A + mu_r).reshape(images.shape)


def match_colors_u8(frames: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) uint8 frames matched to ref (H, W, 3) uint8, hm -> mkl ->
    hm, on the frames' device. Returns a new uint8 tensor."""
    ref = ref.to(torch.uint8)
    cdf_ref = _ref_cdfs(ref)  # shared by both histogram stages
    x = _hist_match_u8(frames.to(torch.uint8), cdf_ref)
    xf = _mkl_transfer_ns(x.float(), ref.float())
    x = torch.clamp(xf + 0.5, 0.0, 255.0).to(torch.uint8)
    return _hist_match_u8(x, cdf_ref)
