"""Plain PyTorch versions of the fused soft-rasterizer forward and backward,
in both schedules of the JAX package.

  raster_fused_fwd_plain        the TPU kernel `_fwd_kernel_compact`
                                (selfcorr_tpu/ops/rasterizer/
                                pallas_raster.py:806): every face at every
                                pixel
  raster_fused_fwd_chunk_plain  `_fwd_kernel` (:730), the dense-chunk
                                schedule: at each pixel only the 16-face
                                chunks that chunks.compute_chunk_info marks
                                for its tile
  raster_fused_bwd_plain        `_bwd_kernel_compact` (:1177, per-pair math
                                `_bwd_chunk_grads` :877)
  raster_fused_bwd_chunk_plain  `_bwd_kernel` (:1117)

All read the packed per-face constants (common.pack_constants). In one pass
over the faces, chunked so memory stays bounded at B*S^2*F scale, the
forward carries

  alpha1 / alpha2  'prod' coverage at sigma1 / sigma2:  1 - prod(1 - D)
  depth            softmax over normalized inverse depth (gamma_d) of the
                   interpolated camera z, white (1.0) background
  tex rgb          softmax (gamma_t) of the soft texture, or with tex_res = R
                   of the surface texel the pixel falls in, white background
  match rgb        hard texture of the nearest containing face; the earliest
                   face wins exact z-ties
  m_d, s_d, m_t, s_t  the running softmax max / sum (backward residuals)

Semantics shared with the CUDA kernels (csrc/) and the JAX kernels:
  * the squared distance is the segment distance min_e d_seg^2 for every
    pixel (it equals the line distance inside the triangle);
  * D = sigmoid(sign * d^2 / sigma) = 1 / (1 + exp(-sign d^2 / sigma)),
    zero for outside faces at d^2 >= sigma * DIST_CUT;
  * a division by a constant (sigma, gamma, far - near) is a multiplication
    by its float32 reciprocal, as in the kernels, so both round alike;
  * interpolation weights are the clipped, renormalized barycentrics; the
    surface texel is cell (floor(c0 R), floor(c1 R)), folded across the
    diagonal (`_surface_texel_sel` :519);
  * faces outside [near, far] keep their coverage but drop out of both
    softmaxes and of the hard pass;
  * excluded faces have their softmax exponent masked to -inf BEFORE the
    exponential, so exp cannot overflow into inf * 0 = nan.

The dense-chunk versions gate each (pixel, face) pair by whether the
schedule visits the face's chunk at the pixel's tile; an unvisited pair
takes part in nothing, so a wrong cull shows up as a difference from the
JAX kernel and from the compact versions.

The running softmax carries start at the background fragment (max bg_eps,
sum 1, accumulator 1 = white), as pallas_raster.py:847-850 does.
"""
from __future__ import annotations

import torch

from benchmark.reference.ops.rasterizer import common as C
from benchmark.reference.ops.rasterizer.chunks import visited_chunks

PLANES = ("alpha1", "alpha2", "depth", "texr", "texg", "texb",
          "matr", "matg", "matb", "m_d", "s_d", "m_t", "s_t")
# the forward planes the backward reads, and the planes with a cotangent
BWD_PLANES = ("alpha1", "alpha2", "depth", "texr", "texg", "texb",
              "m_d", "s_d", "m_t", "s_t")
BWD_GRADS = ("alpha1", "alpha2", "depth", "texr", "texg", "texb")

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


def _pair_geometry(cv, px, py, p2, sigma1, sigma2, gate=None) -> dict:
    """Per-(pixel, face) geometry of one face chunk cv (B, Fc, K) at pixels
    px, py (1, P, 1): barycentrics, segment distances, coverage and
    interpolated depth, in the CUDA kernels' operation order. gate (B, P,
    Fc) bool, when given, drops the pairs it is False at from both
    coverages (and so from everything)."""
    def col(j):
        return cv[:, None, :, j]                          # (B, 1, Fc)

    def affine(j):
        return col(j) * px + col(j + 1) * py + col(j + 2)

    w0 = affine(C.S_WA)
    w1 = affine(C.S_WA + 3)
    w2 = affine(C.S_WA + 6)
    inside = ((w0 > 0) & (w0 < 1) & (w1 > 0) & (w1 < 1)
              & (w2 > 0) & (w2 < 1))
    dis2 = None
    edges = []
    for e in range(3):
        sp = affine(C.S_SEG + 3 * e)
        t = torch.clamp(sp, 0.0, 1.0)
        pv0 = (p2 + col(C.S_PC + 3 * e) * px + col(C.S_PC + 3 * e + 1)
               * py + col(C.S_PC + 3 * e + 2))
        d2e = torch.clamp(pv0 - t * (2.0 * sp - t) * col(C.S_E2 + e),
                          min=0.0)
        edges.append((sp, t, d2e))
        dis2 = d2e if dis2 is None else torch.minimum(dis2, d2e)
    sign = torch.where(inside, 1.0, -1.0)
    contrib1 = inside | (dis2 < sigma1 * C.DIST_CUT)
    contrib2 = inside | (dis2 < sigma2 * C.DIST_CUT)
    if gate is not None:
        contrib1 = contrib1 & gate
        contrib2 = contrib2 & gate
    d1 = 1.0 / (1.0 + torch.exp(-sign * dis2 * (1.0 / sigma1))) * contrib1
    d2 = 1.0 / (1.0 + torch.exp(-sign * dis2 * (1.0 / sigma2))) * contrib2

    c0 = torch.clamp(w0, 0.0, 1.0)
    c1 = torch.clamp(w1, 0.0, 1.0)
    c2 = torch.clamp(w2, 0.0, 1.0)
    wsum = torch.clamp(c0 + c1 + c2, min=1e-5)
    c0, c1, c2 = c0 / wsum, c1 / wsum, c2 / wsum
    zp = 1.0 / (c0 * col(C.S_IZ) + c1 * col(C.S_IZ + 1)
                + c2 * col(C.S_IZ + 2))
    z_ok = (zp >= C.NEAR) & (zp <= C.FAR)
    zn = (C.FAR - zp) * (1.0 / (C.FAR - C.NEAR))
    return dict(w=(w0, w1, w2), inside=inside, edges=edges, dis2=dis2,
                sign=sign, contrib1=contrib1, contrib2=contrib2, d1=d1,
                d2=d2, c=(c0, c1, c2), zp=zp, z_ok=z_ok, zn=zn)


def texel_index(c0: torch.Tensor, c1: torch.Tensor, res: int
                ) -> torch.Tensor:
    """The surface texel (0 .. R^2 - 1, long) at clipped barycentrics c0,
    c1: cell (floor(c0 R), floor(c1 R)), folded when the cell crosses the
    diagonal (pallas_raster.py:519-531, in its operation order)."""
    wx = torch.clamp(torch.floor(c0 * res), 0.0, res - 1.0)
    wy = torch.clamp(torch.floor(c1 * res), 0.0, res - 1.0)
    upper = ((c0 + c1) * res - wx - wy) <= 1.0
    idx = torch.where(upper, wy * res + wx,
                      (res - 1.0 - wy) * res + (res - 1.0 - wx))
    return idx.long().clamp(0, res * res - 1)   # NaN weights stay in range


def _texel_flat(cv, idx, res):
    """Flat (B, Fc * R^2) positions of texel idx (B, P, Fc) of each face,
    for gather / scatter over cv's faces."""
    fc = cv.shape[1]
    face = torch.arange(fc, device=cv.device) * (res * res)
    return (idx + face).reshape(idx.shape[0], -1)


def _tex_colors(cv, c, tex_res):
    """The three (B, P, Fc) texture channels of each pair: the soft
    texture interpolated at the weights c, or the surface texel."""
    c0, c1, c2 = c
    if not tex_res:
        return [c0 * cv[:, None, :, C.S_STEX + ch]
                + c1 * cv[:, None, :, C.S_STEX + 3 + ch]
                + c2 * cv[:, None, :, C.S_STEX + 6 + ch] for ch in range(3)]
    b, fc = cv.shape[:2]
    n = tex_res * tex_res
    texels = cv[..., C.S_SURF:C.S_SURF + 3 * n].reshape(b, fc * n, 3)
    flat = _texel_flat(cv, texel_index(c0, c1, tex_res), tex_res)
    return [texels[..., ch].gather(1, flat).reshape(c0.shape)
            for ch in range(3)]


def _chunk_size(b, p, f, faces_per_chunk):
    if faces_per_chunk is None:
        faces_per_chunk = max(1, _CHUNK_ELEMS // max(b * p, 1))
    return max(1, min(faces_per_chunk, f))


def _gate(visit, f0, fc):
    """The (B, P, fc) pair gate of faces f0 .. f0 + fc from the (B, P,
    n_chunks) visit mask, or None."""
    if visit is None:
        return None
    ci = torch.arange(f0, f0 + fc, device=visit.device) // C.FF
    return visit[:, :, ci]


def _check_tex_res(consts, tex_res):
    if consts.shape[-1] != C.k_for(tex_res):
        raise ValueError(f"tex_res={tex_res} needs {C.k_for(tex_res)} "
                         f"packed slots per face, got {consts.shape[-1]}")


def _bwd(consts, planes, grads, image_size, sigma1, sigma2, gamma_d,
         gamma_t, tex_res, visit, faces_per_chunk):
    _check_tex_res(consts, tex_res)
    b, f, k_tot = consts.shape
    s_img = image_size
    p = s_img * s_img
    dev = consts.device
    xp, yp = C.pixel_grid(s_img, device=dev)
    px = xp[None, :, None]
    py = yp[None, :, None]
    p2 = px * px + py * py
    fc = _chunk_size(b, p, f, faces_per_chunk)
    inv_s1, inv_s2 = 1.0 / sigma1, 1.0 / sigma2
    inv_gd, inv_gt = 1.0 / gamma_d, 1.0 / gamma_t
    inv_range = 1.0 / (C.FAR - C.NEAR)

    def pix(d, n):
        return d[n].reshape(b, p, 1).float()

    p1_tot = 1.0 - pix(planes, "alpha1")
    p2_tot = 1.0 - pix(planes, "alpha2")
    out_d = pix(planes, "depth")
    out_t = [pix(planes, n) for n in ("texr", "texg", "texb")]
    m_d, s_d = pix(planes, "m_d"), pix(planes, "s_d")
    m_t, s_t = pix(planes, "m_t"), pix(planes, "s_t")
    g_a1, g_a2, g_d = (pix(grads, n) for n in ("alpha1", "alpha2", "depth"))
    g_t = [pix(grads, n) for n in ("texr", "texg", "texb")]
    out = torch.zeros((b, f, k_tot), dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    for f0 in range(0, f, fc):
        cv = consts[:, f0:f0 + fc]
        n_f = cv.shape[1]

        def col(j):
            return cv[:, None, :, j]

        g = _pair_geometry(cv, px, py, p2, sigma1, sigma2,
                           _gate(visit, f0, n_f))
        c0, c1, c2 = g["c"]
        d1, d2, sign, zp, zn = g["d1"], g["d2"], g["sign"], g["zp"], g["zn"]
        con1, con2, z_ok = g["contrib1"], g["contrib2"], g["z_ok"]
        live = con1 | con2

        # coverage (alpha2) chain
        dl_dd2 = g_a2 * p2_tot / torch.clamp(1.0 - d2, min=1e-6)

        # alpha1 + depth softmax chain, where sigma1 covers
        u_d = torch.exp((torch.where(con1 & z_ok, zn, neg_inf) - m_d)
                        * inv_gd) / s_d
        val_d = (c0 * (col(C.S_Z) - C.EYE_OFFSET)
                 + c1 * (col(C.S_Z + 1) - C.EYE_OFFSET)
                 + c2 * (col(C.S_Z + 2) - C.EYE_OFFSET))
        r_d = val_d - out_d
        wgt_d = d1 * u_d
        dl_dd1 = (g_a1 * p1_tot / torch.clamp(1.0 - d1, min=1e-6)
                  + g_d * r_d * u_d)
        ddis2_1 = torch.where(con1, dl_dd1 * sign * d1 * (1.0 - d1)
                              * inv_s1, 0.0)
        dzn_1 = torch.where(con1, g_d * r_d * wgt_d * inv_gd, 0.0)
        dl_dval = torch.where(con1, g_d * wgt_d, 0.0)

        # texture softmax chain
        u_t = torch.exp((torch.where(con2 & z_ok, zn, neg_inf) - m_t)
                        * inv_gt) / s_t
        cols = _tex_colors(cv, g["c"], tex_res)
        gr_dot = (g_t[0] * (cols[0] - out_t[0]) + g_t[1] * (cols[1] - out_t[1])
                  + g_t[2] * (cols[2] - out_t[2]))
        wgt_t = d2 * u_t
        dl_dd2 = dl_dd2 + gr_dot * u_t
        dl_dzn = dzn_1 + gr_dot * wgt_t * inv_gt
        dcol = [torch.where(live, g_t[ch] * wgt_t, 0.0) for ch in range(3)]

        # D -> dis2; zn -> zp -> 1/z
        dl_ddis2 = torch.where(live, ddis2_1 + dl_dd2 * sign * d2
                               * (1.0 - d2) * inv_s2, 0.0)
        diz = torch.where(live, -(-dl_dzn * inv_range) * (zp * zp), 0.0)

        slots = {}
        chosen = None
        for e, (sp, t, d2e) in enumerate(g["edges"]):
            is_min = d2e == g["dis2"]
            sel = is_min if chosen is None else is_min & ~chosen
            chosen = is_min if chosen is None else chosen | is_min
            f_e = dl_ddis2 * sel
            ds_raw = f_e * (-2.0 * t * col(C.S_E2 + e))
            slots[C.S_SEG + 3 * e] = ds_raw * px
            slots[C.S_SEG + 3 * e + 1] = ds_raw * py
            slots[C.S_SEG + 3 * e + 2] = ds_raw
            slots[C.S_E2 + e] = f_e * (t * t - 2.0 * t * sp)
            slots[C.S_PC + 3 * e] = f_e * px
            slots[C.S_PC + 3 * e + 1] = f_e * py
            slots[C.S_PC + 3 * e + 2] = f_e
        for k, ck in enumerate((c0, c1, c2)):
            slots[C.S_IZ + k] = diz * ck
            slots[C.S_Z + k] = dl_dval * ck
            if not tex_res:
                for ch in range(3):
                    slots[C.S_STEX + 3 * k + ch] = dcol[ch] * ck
        for slot, v in slots.items():
            out[:, f0:f0 + fc, slot] = v.sum(dim=1)
        if tex_res:
            # each pair's texture cotangent goes to its one texel
            n = tex_res * tex_res
            flat = _texel_flat(cv, texel_index(c0, c1, tex_res), tex_res)
            for ch in range(3):
                acc = torch.zeros((b, n_f * n), dtype=torch.float32,
                                  device=dev)
                acc.scatter_add_(1, flat, dcol[ch].reshape(b, -1))
                out[:, f0:f0 + fc, C.S_SURF + ch:C.S_SURF + 3 * n:3] = \
                    acc.reshape(b, n_f, n)
    return out


def raster_fused_bwd_plain(consts: torch.Tensor, planes: dict, grads: dict,
                           image_size: int, sigma1: float, sigma2: float,
                           gamma_d: float, gamma_t: float, tex_res: int = 0,
                           faces_per_chunk: int | None = None
                           ) -> torch.Tensor:
    """Gradient of the loss with respect to the packed constants.

    consts (B, F, K) float32; planes: the forward's BWD_PLANES, grads: the
    cotangents of BWD_GRADS, each (B, S, S). Returns (B, F, K) float32.

    A transcription of the TPU kernel's per-pair chain `_bwd_chunk_grads`
    (pallas_raster.py:877-1075), not autograd of the forward: interpolation
    weights are constants (slots S_WA, S_FRONT, S_BBOX, S_HTEX get zero);
    the coverage cotangent is g * p_tot / max(1 - D, 1e-6); the depth chain
    runs where sigma1 covers; texture weights are contrib2 & z_ok; dis2 takes
    its gradient from the first minimizing edge; then zn -> zp -> 1/z. With
    tex_res the texture cotangent goes to the pair's texel slot
    S_SURF + 3t + ch (:1016-1020) and S_STEX gets zero. Pairs that neither
    sigma covers contribute nothing, as in the CUDA kernels, which skip
    them."""
    return _bwd(consts, planes, grads, image_size, sigma1, sigma2, gamma_d,
                gamma_t, tex_res, None, faces_per_chunk)


def raster_fused_bwd_chunk_plain(consts: torch.Tensor, spans: torch.Tensor,
                                 masks: torch.Tensor, planes: dict,
                                 grads: dict, image_size: int, sigma1: float,
                                 sigma2: float, gamma_d: float,
                                 gamma_t: float, tex_res: int = 0,
                                 faces_per_chunk: int | None = None
                                 ) -> torch.Tensor:
    """raster_fused_bwd_plain over the pairs the dense-chunk schedule visits
    (spans, masks from chunks.compute_chunk_info at image_size)."""
    visit = visited_chunks(spans, masks, image_size, consts.shape[1] // C.FF)
    return _bwd(consts, planes, grads, image_size, sigma1, sigma2, gamma_d,
                gamma_t, tex_res, visit, faces_per_chunk)


def _fwd(consts, image_size, sigma1, sigma2, gamma_d, gamma_t, tex_res,
         visit, faces_per_chunk, pair_counts):
    _check_tex_res(consts, tex_res)
    bg_eps, z_offset = C.BG_EPS, C.EYE_OFFSET
    b, f, _ = consts.shape
    s_img = image_size
    p = s_img * s_img
    dev = consts.device
    xp, yp = C.pixel_grid(s_img, device=dev)
    px = xp[None, :, None]
    py = yp[None, :, None]
    p2 = px * px + py * py
    fc = _chunk_size(b, p, f, faces_per_chunk)

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

        g = _pair_geometry(cv, px, py, p2, sigma1, sigma2,
                           _gate(visit, f0, cv.shape[1]))
        w0, w1, w2 = g["w"]
        c0, c1, c2 = g["c"]
        d1, d2, zp, z_ok, zn = g["d1"], g["d2"], g["zp"], g["z_ok"], g["zn"]
        contrib1, contrib2 = g["contrib1"], g["contrib2"]

        p1 = p1 * torch.prod(1.0 - d1, dim=-1)
        p2_prod = p2_prod * torch.prod(1.0 - d2, dim=-1)

        # texture softmax (sigma2 coverage)
        tex = _tex_colors(cv, g["c"], tex_res)
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


def raster_fused_fwd_plain(consts: torch.Tensor, image_size: int,
                           sigma1: float, sigma2: float, gamma_d: float,
                           gamma_t: float, tex_res: int = 0,
                           faces_per_chunk: int | None = None,
                           pair_counts: dict | None = None) -> dict:
    """consts (B, F, K) float32 -> dict of the 13 (B, S, S) float32 planes
    named in PLANES. tex_res = R > 0 takes the texture from the surface
    texels at S_SURF (K = common.k_for(R)).

    pair_counts, when given, is filled with the number of (face, pixel)
    pairs that do each part of the work: "cover" (some coverage: inside or
    within a cutoff), "cover1" / "cover2" (coverage at sigma1 / sigma2),
    "tex" (texture softmax) and "depth" (depth softmax and hard test)."""
    return _fwd(consts, image_size, sigma1, sigma2, gamma_d, gamma_t,
                tex_res, None, faces_per_chunk, pair_counts)


def raster_fused_fwd_chunk_plain(consts: torch.Tensor, spans: torch.Tensor,
                                 masks: torch.Tensor, image_size: int,
                                 sigma1: float, sigma2: float,
                                 gamma_d: float, gamma_t: float,
                                 tex_res: int = 0,
                                 faces_per_chunk: int | None = None,
                                 pair_counts: dict | None = None) -> dict:
    """raster_fused_fwd_plain over the pairs the dense-chunk schedule visits
    (spans, masks from chunks.compute_chunk_info at image_size)."""
    visit = visited_chunks(spans, masks, image_size, consts.shape[1] // C.FF)
    return _fwd(consts, image_size, sigma1, sigma2, gamma_d, gamma_t,
                tex_res, visit, faces_per_chunk, pair_counts)
