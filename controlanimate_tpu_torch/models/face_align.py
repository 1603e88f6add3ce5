"""Landmark-aligned face crop and soft-mask paste, on the frames' device.

Counterpart of `controlanimate_tpu/models/face_align.py` (facexlib's
FaceRestoreHelper geometry): a similarity transform maps 5 landmarks onto
the FFHQ template at `face_size`, the frame is warped to the crop, and the
restored crop goes back through the scaled inverse affine under an eroded
and Gaussian-blurred mask. The 5-point fits (`estimate_similarity`,
`invert_affine`) run in float64 numpy on the host, as in the JAX package;
the warps, erosions and blur run on the frames' device through
`ops/warp.py`, the port's OpenCV.

Not ported: `landmarks_from_box`, which serves only the JAX package's Haar
cascade fallback (the port needs the RetinaFace weights).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.warp import erode, gaussian_blur, warp_affine

# facexlib's 'ffhq512' template: left eye, right eye, nose, left and right
# mouth corners of a 512x512 aligned crop
FFHQ_TEMPLATE_512 = np.array(
    [
        [192.98138, 239.94708],
        [318.90277, 240.1936],
        [256.63416, 314.01935],
        [201.26117, 371.41043],
        [313.08905, 371.15118],
    ],
    dtype=np.float32,
)

# the crop's fill outside the frame (facexlib's neutral gray)
BORDER_VALUE = (135, 133, 132)


def estimate_similarity(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity (rotation, scale, translation) mapping the
    (N, 2) points src onto dst, Umeyama's closed form in float64; a 2x3
    float32 matrix."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 2:
        raise ValueError(f"expected matching (N,2) point sets, got {src.shape} vs {dst.shape}")
    mu_s, mu_d = src.mean(0), dst.mean(0)
    sc, dc = src - mu_s, dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, d])
    R = U @ D @ Vt
    var_s = (sc**2).sum() / src.shape[0]
    scale = (S * np.diag(D)).sum() / var_s
    M = np.empty((2, 3), np.float64)
    M[:, :2] = scale * R
    M[:, 2] = mu_d - scale * R @ mu_s
    return M.astype(np.float32)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """`cv2.invertAffineTransform`, in float64, returned as float32."""
    A = np.asarray(M, np.float64)
    Rinv = np.linalg.inv(A[:, :2])
    out = np.empty((2, 3), np.float64)
    out[:, :2] = Rinv
    out[:, 2] = -Rinv @ A[:, 2]
    return out.astype(np.float32)


def align_face(frame: torch.Tensor, landmarks5: np.ndarray,
               face_size: int = 512) -> tuple[torch.Tensor, np.ndarray]:
    """Warp the (H, W, 3) uint8 `frame` so `landmarks5` land on the FFHQ
    template: ((face_size, face_size, 3) uint8 on the frame's device, the
    2x3 frame -> crop affine on the host)."""
    template = FFHQ_TEMPLATE_512 * (face_size / 512.0)
    M = estimate_similarity(np.asarray(landmarks5, np.float32), template)
    return warp_affine(frame, M, (face_size, face_size), BORDER_VALUE), M


def paste_face(background: torch.Tensor, restored_face: torch.Tensor, affine: np.ndarray,
               upscale_factor: float = 1.0) -> torch.Tensor:
    """Paste the restored aligned crop into `background` ((H, W, 3) at
    `upscale_factor` times the detection frame) through the scaled inverse
    affine, under facexlib's soft mask: the warped crop's mask eroded by
    2 * upscale px, then by 2 * (sqrt(area) // 20) px and blurred over
    2 * (sqrt(area) // 20) + 1 px. Returns float32 on the background's
    device; one readback (the mask's area, which sets the radii)."""
    bg = background.float()
    h_up, w_up = bg.shape[:2]
    face_size = restored_face.shape[0]
    inv = invert_affine(np.asarray(affine, np.float32)) * np.float32(upscale_factor)
    if upscale_factor > 1:
        # half-pixel compensation, so the upscaled paste lands on pixel centres
        inv[:, 2] += np.float32(0.5 * upscale_factor)
    inv_restored = warp_affine(restored_face.float(), inv, (w_up, h_up))
    mask = torch.ones((face_size, face_size, 1), dtype=torch.float32, device=bg.device)
    inv_mask = warp_affine(mask, inv, (w_up, h_up))[..., 0]
    inv_mask_erosion = erode(inv_mask, max(int(2 * upscale_factor), 1))
    total_face_area = float(inv_mask_erosion.double().sum())
    if total_face_area <= 0:
        return bg
    pasted_face = inv_mask_erosion[..., None] * inv_restored
    w_edge = int(total_face_area**0.5) // 20
    inv_mask_center = erode(inv_mask_erosion, max(w_edge * 2, 1))
    inv_soft_mask = gaussian_blur(inv_mask_center, w_edge * 2 + 1)[..., None]
    return inv_soft_mask * pasted_face + (1 - inv_soft_mask) * bg
