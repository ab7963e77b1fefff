"""Plain PyTorch version of the fused soft-rasterizer forward.

Computes what the TPU kernel `_fwd_kernel_compact`
(selfcorr_tpu/ops/rasterizer/pallas_raster.py:806) computes, from the same
packed per-face constants (common.pack_constants): in one pass over the
faces, chunked so memory stays bounded at B*S^2*F scale, it carries

  alpha1 / alpha2  'prod' coverage at sigma1 / sigma2:  1 - prod(1 - D)
  depth            softmax over normalized inverse depth (gamma_d) of the
                   interpolated camera z, white (1.0) background
  tex rgb          softmax (gamma_t) of the soft texture, white background
  match rgb        hard texture of the nearest containing face; the earliest
                   face wins exact z-ties
  m_d, s_d, m_t, s_t  the running softmax max / sum (backward residuals)

Semantics shared with the kernel (csrc/raster_fwd.cu) and the JAX kernel:
  * the squared distance is the segment distance min_e d_seg^2 for every
    pixel (it equals the line distance inside the triangle);
  * D = sigmoid(sign * d^2 / sigma) = 1 / (1 + exp(-sign d^2 / sigma)),
    zero for outside faces at d^2 >= sigma * DIST_CUT;
  * a division by a constant (sigma, gamma, far - near) is a multiplication
    by its float32 reciprocal, as in the kernel, so both round alike;
  * interpolation weights are the clipped, renormalized barycentrics;
  * faces outside [near, far] keep their coverage but drop out of both
    softmaxes and of the hard pass;
  * excluded faces have their softmax exponent masked to -inf BEFORE the
    exponential, so exp cannot overflow into inf * 0 = nan.

The running softmax carries start at the background fragment (max bg_eps,
sum 1, accumulator 1 = white), as pallas_raster.py:847-850 does.
"""
from __future__ import annotations

import torch

from selfcorr_tpu_torch.ops.rasterizer import common as C

PLANES = ("alpha1", "alpha2", "depth", "texr", "texg", "texb",
          "matr", "matg", "matb", "m_d", "s_d", "m_t", "s_t")

# elements of one (B, P, faces-per-chunk) temporary
_CHUNK_ELEMS = 1 << 22


def _softmax_update(m, s, accs, zn_masked, d_cov, values, gamma):
    """Streaming-softmax update over one face chunk (faces on the last
    axis). zn_masked is -inf where a face is excluded."""
    inv_gamma = 1.0 / gamma
    m_new = torch.maximum(m, zn_masked.amax(-1))
    scale = torch.exp((m - m_new) * inv_gamma)
    wgt = d_cov * torch.exp((zn_masked - m_new[..., None]) * inv_gamma)
    s_new = s * scale + wgt.sum(-1)
    accs_new = [a * scale + (wgt * v).sum(-1) for a, v in zip(accs, values)]
    return m_new, s_new, accs_new


def raster_fused_fwd_plain(consts: torch.Tensor, image_size: int,
                           sigma1: float, sigma2: float, gamma_d: float,
                           gamma_t: float,
                           faces_per_chunk: int | None = None,
                           pair_counts: dict | None = None) -> dict:
    """consts (B, F, K) float32 -> dict of the 13 (B, S, S) float32 planes
    named in PLANES.

    pair_counts, when given, is filled with the number of (face, pixel)
    pairs that do each part of the work: "cover" (some coverage: inside or
    within a cutoff), "cover1" / "cover2" (coverage at sigma1 / sigma2),
    "tex" (texture softmax) and "depth" (depth softmax and hard test)."""
    near, far, bg_eps, z_offset = C.NEAR, C.FAR, C.BG_EPS, C.EYE_OFFSET
    b, f, _ = consts.shape
    s_img = image_size
    p = s_img * s_img
    dev = consts.device
    xp, yp = C.pixel_grid(s_img, device=dev)
    px = xp[None, :, None]
    py = yp[None, :, None]
    p2 = px * px + py * py
    if faces_per_chunk is None:
        faces_per_chunk = max(1, _CHUNK_ELEMS // max(b * p, 1))
    fc = max(1, min(faces_per_chunk, f))

    def full(v):
        return torch.full((b, p), v, dtype=torch.float32, device=dev)

    p1, p2_prod = full(1.0), full(1.0)
    m_d, s_d, acc_d = full(bg_eps), full(1.0), full(1.0)
    m_t, s_t = full(bg_eps), full(1.0)
    acc_t = [full(1.0), full(1.0), full(1.0)]
    zmin = full(float("inf"))
    hard = [full(0.0), full(0.0), full(0.0)]
    counts = dict.fromkeys(("cover", "cover1", "cover2", "tex", "depth"), 0)
    neg_inf = torch.tensor(float("-inf"), device=dev)
    pos_inf = torch.tensor(float("inf"), device=dev)

    for f0 in range(0, f, fc):
        cv = consts[:, f0:f0 + fc]

        def col(j):
            return cv[:, None, :, j]                      # (B, 1, Fc)

        def affine(j):
            return col(j) * px + col(j + 1) * py + col(j + 2)

        w0 = affine(C.S_WA)
        w1 = affine(C.S_WA + 3)
        w2 = affine(C.S_WA + 6)
        inside = ((w0 > 0) & (w0 < 1) & (w1 > 0) & (w1 < 1)
                  & (w2 > 0) & (w2 < 1))
        dis2 = None
        for e in range(3):
            sp = affine(C.S_SEG + 3 * e)
            t = torch.clamp(sp, 0.0, 1.0)
            pv0 = (p2 + col(C.S_PC + 3 * e) * px + col(C.S_PC + 3 * e + 1)
                   * py + col(C.S_PC + 3 * e + 2))
            d2e = torch.clamp(pv0 - t * (2.0 * sp - t) * col(C.S_E2 + e),
                              min=0.0)
            dis2 = d2e if dis2 is None else torch.minimum(dis2, d2e)
        sign = torch.where(inside, 1.0, -1.0)
        contrib1 = inside | (dis2 < sigma1 * C.DIST_CUT)
        contrib2 = inside | (dis2 < sigma2 * C.DIST_CUT)
        d1 = 1.0 / (1.0 + torch.exp(-sign * dis2 * (1.0 / sigma1))) \
            * contrib1
        d2 = 1.0 / (1.0 + torch.exp(-sign * dis2 * (1.0 / sigma2))) \
            * contrib2

        c0 = torch.clamp(w0, 0.0, 1.0)
        c1 = torch.clamp(w1, 0.0, 1.0)
        c2 = torch.clamp(w2, 0.0, 1.0)
        wsum = torch.clamp(c0 + c1 + c2, min=1e-5)
        c0, c1, c2 = c0 / wsum, c1 / wsum, c2 / wsum
        zp = 1.0 / (c0 * col(C.S_IZ) + c1 * col(C.S_IZ + 1)
                    + c2 * col(C.S_IZ + 2))
        z_ok = (zp >= near) & (zp <= far)
        zn = (far - zp) * (1.0 / (far - near))

        p1 = p1 * torch.prod(1.0 - d1, dim=-1)
        p2_prod = p2_prod * torch.prod(1.0 - d2, dim=-1)

        # texture softmax (sigma2 coverage)
        tex = [c0 * col(C.S_STEX + ch) + c1 * col(C.S_STEX + 3 + ch)
               + c2 * col(C.S_STEX + 6 + ch) for ch in range(3)]
        zn_t = torch.where(contrib2 & z_ok, zn, neg_inf)
        m_t, s_t, acc_t = _softmax_update(m_t, s_t, acc_t, zn_t, d2, tex,
                                          gamma_t)

        # depth softmax (sigma1 coverage) of camera z
        val_d = (c0 * (col(C.S_Z) - z_offset) + c1 * (col(C.S_Z + 1)
                 - z_offset) + c2 * (col(C.S_Z + 2) - z_offset))
        zn_d = torch.where(contrib1 & z_ok, zn, neg_inf)
        m_d, s_d, (acc_d,) = _softmax_update(m_d, s_d, [acc_d], zn_d, d1,
                                             [val_d], gamma_d)

        # hard pass: nearest containing face; argmin keeps the first on ties
        inside_ns = ((w0 >= 0) & (w0 <= 1) & (w1 >= 0) & (w1 <= 1)
                     & (w2 >= 0) & (w2 <= 1))
        hard_ok = inside_ns & contrib1 & z_ok
        zp_h = torch.where(hard_ok, zp, pos_inf)
        win = zp_h.argmin(dim=-1)
        chunk_min = torch.gather(zp_h, -1, win[..., None])[..., 0]
        is_new = chunk_min < zmin
        for ch in range(3):
            hc = (c0 * col(C.S_HTEX + ch) + c1 * col(C.S_HTEX + 3 + ch)
                  + c2 * col(C.S_HTEX + 6 + ch))
            hc = torch.gather(hc, -1, win[..., None])[..., 0]
            hard[ch] = torch.where(is_new, hc, hard[ch])
        zmin = torch.minimum(zmin, chunk_min)
        if pair_counts is not None:
            for k, m in (("cover", contrib1 | contrib2), ("cover1", contrib1),
                         ("cover2", contrib2), ("tex", contrib2 & z_ok),
                         ("depth", contrib1 & z_ok)):
                counts[k] += int(m.sum())

    if pair_counts is not None:
        pair_counts.update(counts)

    planes = [1.0 - p1, 1.0 - p2_prod, acc_d / s_d,
              acc_t[0] / s_t, acc_t[1] / s_t, acc_t[2] / s_t,
              hard[0], hard[1], hard[2], m_d, s_d, m_t, s_t]
    return {n: v.reshape(b, s_img, s_img) for n, v in zip(PLANES, planes)}
