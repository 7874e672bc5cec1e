"""Golden-parity oracle: direct NumPy per-voxel transliterations of the
reference's algorithms, used as an independent test oracle for the batched
device kernels.

Each function here follows the reference's Julia code line by line (0-based
indices, numpy in place of BLAS), deliberately NOT sharing any code with
the fibers_tpu package — if either side's math drifts, the parity tests in
test_oracle.py fail.

Transliterated from:
- GQI per-voxel:   /root/reference/src/gqi.jl:132-201
- DTI per-voxel:   /root/reference/src/dti.jl:286-316 (ragged pinv path)
- RUMBA iterate:   /root/reference/src/rusd.jl:183-339
- stream_new_line: /root/reference/src/stream.jl:336-374, 501-541, 625-686
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------- #
# GQI (reference: src/gqi.jl)
# --------------------------------------------------------------------- #

def gqi_system_matrix(bval, bvec, vertices, sigma=1.25):
    """A [nvert, nvol] (reference: src/gqi.jl:66-69).  `vertices` is the
    full 2*nvert table; uses the second half like the reference."""
    nvert = len(vertices) // 2
    bq = np.asarray(bvec, np.float64) * (
        np.sqrt(np.asarray(bval, np.float64) * 0.01506)[:, None]
        * (sigma / np.pi))
    # Julia sinc is the normalized sinc, same as numpy's
    return np.sinc(np.asarray(vertices[nvert:], np.float64) @ bq.T)


def find_peaks_oracle(o, faces_half):
    """Zero every vertex that is not a strict local max over its face
    neighborhoods; return (odf_peak, isort) (reference: src/gqi.jl:180-201).
    `faces_half` is 0-based, already folded onto the half sphere."""
    o = np.asarray(o)
    f = faces_half
    odf_peak = o.copy()
    c0 = (o[f[:, 1]] >= o[f[:, 0]]) | (o[f[:, 2]] >= o[f[:, 0]])
    c1 = (o[f[:, 0]] >= o[f[:, 1]]) | (o[f[:, 2]] >= o[f[:, 1]])
    c2 = (o[f[:, 1]] >= o[f[:, 2]]) | (o[f[:, 0]] >= o[f[:, 2]])
    odf_peak[f[c0, 0]] = 0
    odf_peak[f[c1, 1]] = 0
    odf_peak[f[c2, 2]] = 0
    isort = np.argsort(-odf_peak, kind="stable")
    nvalid = int((odf_peak > 0).sum())
    return isort, nvalid


def gqi_oracle(vol, mask, bval, bvec, vertices, faces, sigma=1.25,
               npeak=3):
    """Whole-volume per-voxel GQI (reference: src/gqi.jl:109-171).

    vertices/faces: full-sphere tessellation, faces 0-based.
    Returns (odf [X,Y,Z,nvert], peak list of [X,Y,Z,3], qa list of [X,Y,Z]).
    """
    nvert = len(vertices) // 2
    A = gqi_system_matrix(bval, bvec, vertices, sigma).astype(np.float32)
    # faces in the tessellation tables are 1-based (Julia); fold onto the
    # half sphere like the reference, then shift to 0-based
    faces_half = faces.astype(np.int64).copy()
    faces_half[faces_half > nvert] -= nvert
    faces_half -= 1

    nx, ny, nz = mask.shape[:3]
    odf = np.zeros((nx, ny, nz, nvert), np.float32)
    peak = [np.zeros((nx, ny, nz, 3), np.float32) for _ in range(npeak)]
    qa = [np.zeros((nx, ny, nz), np.float32) for _ in range(npeak)]

    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                if mask[ix, iy, iz] == 0:
                    continue
                s = np.maximum(vol[ix, iy, iz, :].astype(np.float32), 0)
                if s.max() == 0:
                    continue
                o = A @ s
                odf[ix, iy, iz, :] = o
                odfmin = o.min()
                isort, nvalid = find_peaks_oracle(o, faces_half)
                for ip in range(min(nvalid, npeak)):
                    peak[ip][ix, iy, iz, :] = vertices[isort[ip]]
                    qa[ip][ix, iy, iz] = o[isort[ip]] - odfmin

    odfmax = odf.mean(axis=3).max()
    for ip in range(npeak):
        qa[ip] /= odfmax
    return odf, peak, qa


# --------------------------------------------------------------------- #
# DTI (reference: src/dti.jl)
# --------------------------------------------------------------------- #

def dti_design(bval, bvec):
    """[nvol, 7] design (reference: src/dti.jl:129-140)."""
    gx, gy, gz = bvec[:, 0], bvec[:, 1], bvec[:, 2]
    a = np.stack([gx * gx, 2 * gx * gy, 2 * gx * gz,
                  gy * gy, 2 * gy * gz, gz * gz], axis=1)
    a = -np.asarray(bval)[:, None] * a
    return np.concatenate([a, np.ones((len(bval), 1))], axis=1)


def dti_fit_voxel_oracle(dwi, bval, bvec):
    """Single-voxel LS tensor fit incl. the ragged positive-subset pinv
    path (reference: src/dti.jl:286-316).

    Returns dict(s0, eigval1..3 desc, eigvec1..3, rd, md, fa)."""
    A = dti_design(bval, bvec)
    ib0 = bval == bval.min()
    ipos = dwi > 0
    npos = int(ipos.sum())
    nvol = len(dwi)

    zeros = dict(s0=0.0, eigval1=0.0, eigval2=0.0, eigval3=0.0,
                 eigvec1=np.zeros(3), eigvec2=np.zeros(3),
                 eigvec3=np.zeros(3), rd=0.0, md=0.0, fa=0.0)
    if npos == nvol:
        d = np.linalg.pinv(A) @ np.log(dwi)
    elif npos > 6 and ipos[ib0].any():
        d = np.linalg.pinv(A[ipos, :]) @ np.log(dwi[ipos])
    else:
        return zeros

    s0 = np.exp(d[6])
    D = np.array([[d[0], d[1], d[2]],
                  [d[1], d[3], d[4]],
                  [d[2], d[4], d[5]]])
    evals, evecs = np.linalg.eigh(D)        # ascending, like Julia eigen

    l1, l2, l3 = evals[2], evals[1], evals[0]
    rd = l2 + l3
    md = (l1 + rd) / 3
    rd /= 2
    fa = np.sqrt(((l1 - md) ** 2 + (l2 - md) ** 2 + (l3 - md) ** 2)
                 / (l1 ** 2 + l2 ** 2 + l3 ** 2) * 1.5)
    return dict(s0=s0, eigval1=l1, eigval2=l2, eigval3=l3,
                eigvec1=evecs[:, 2], eigvec2=evecs[:, 1],
                eigvec3=evecs[:, 0], rd=rd, md=md, fa=fa)


def u16_wire_oracle(rows, vmax):
    """The signal rows as the uint16 upload wire delivers them: one global
    step vmax/65535 (vmax = the masked signal's maximum), each sample
    clipped to [0, 65535] steps and rounded half up, then scaled back.
    Samples below half a step arrive as 0."""
    step = float(vmax) / 65535.0
    q = np.floor(np.clip(np.asarray(rows, np.float64) / step, 0.0, 65535.0)
                 + 0.5)
    return q * step


def adc_fit_voxel_oracle(dwi, bval):
    """Single-voxel ADC fit (reference: src/dti.jl:190-213)."""
    A = np.stack([-np.asarray(bval), np.ones(len(bval))], axis=1)
    ib0 = bval == bval.min()
    ipos = dwi > 0
    npos = int(ipos.sum())
    if npos == len(dwi):
        d = np.linalg.pinv(A) @ np.log(dwi)
    elif npos > 6 and ipos[ib0].any():
        d = np.linalg.pinv(A[ipos, :]) @ np.log(dwi[ipos])
    else:
        return 0.0, 0.0
    return d[0], np.exp(d[1])


# --------------------------------------------------------------------- #
# DSI (reference: src/dsi.jl:59-261)
# --------------------------------------------------------------------- #

def _trilinear(vol, x, y, z):
    """Linear interpolation at one (0-based) point of a 3D volume."""
    n = vol.shape[0]
    x0, y0, z0 = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
    fx, fy, fz = x - x0, y - y0, z - z0
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))
                out += w * vol[min(max(x0 + dx, 0), n - 1),
                               min(max(y0 + dy, 0), n - 1),
                               min(max(z0 + dz, 0), n - 1)]
    return out


def dsi_voxel_oracle(signal, bval, bvec, vertices, hann_width=32):
    """Single-voxel DSI reconstruction (reference: src/dsi.jl:59-261).

    Returns (pdf at the q-space samples [nvol], odf [nvert])."""
    bval = np.asarray(bval, np.float64)
    q = np.asarray(bvec, np.float64) * np.sqrt(bval)[:, None]
    bmin = bval.min()
    dq = np.sqrt(bval[bval > bmin].min())
    iq = np.round(q / dq).astype(int)

    nfft = int(iq.max() - iq.min() + 1)
    nfft = 1 << int(np.ceil(np.log2(nfft)))
    shift0 = nfft // 2                       # 0-based center
    iq0 = iq + shift0

    X = np.zeros((nfft, nfft, nfft))
    X[iq0[:, 0], iq0[:, 1], iq0[:, 2]] = np.maximum(signal, 0)
    if hann_width:
        w = (1 + np.cos(np.sqrt((iq ** 2).sum(1)) * 2 * np.pi
                        / hann_width)) * 0.5
        X[iq0[:, 0], iq0[:, 1], iq0[:, 2]] *= w

    sh = (shift0, shift0, shift0)
    x = np.roll(np.fft.fftn(np.roll(X, sh, (0, 1, 2))), sh, (0, 1, 2))
    p = np.real(x)
    p = p / p.sum()
    pdf = p[iq0[:, 0], iq0[:, 1], iq0[:, 2]]

    nvert = len(vertices) // 2
    verts = np.asarray(vertices[nvert:], np.float64)
    qr = (nfft / 2 - 1) * np.arange(0.3, 0.9 + 1e-9, 0.03)
    dqr = qr[1] - qr[0]
    odf = np.zeros(nvert)
    for iv in range(nvert):
        for r in qr:
            c = verts[iv] * r + shift0
            odf[iv] += _trilinear(p, c[0], c[1], c[2]) * r * r
        odf[iv] *= dqr
    return pdf.astype(np.float32), odf.astype(np.float32)


# --------------------------------------------------------------------- #
# RUMBA-SD single iteration (reference: src/rusd.jl:183-339)
# --------------------------------------------------------------------- #

def besseli_ratio_oracle(nu, z):
    """(reference: src/rusd.jl:170-177)"""
    return z / ((2 * nu + z)
                - ((2 * nu + 1) * z
                   / (2 * z + (2 * nu + 1)
                      - ((2 * nu + 3) * z
                         / ((2 * nu + 2) + 2 * z
                            - ((2 * nu + 5) * z
                               / ((2 * nu + 3) + 2 * z)))))))


def _sd_grad(v):
    gx = np.concatenate([v[1:], v[-1:]], axis=0) - v
    gy = np.concatenate([v[:, 1:], v[:, -1:]], axis=1) - v
    gz = np.concatenate([v[:, :, 1:], v[:, :, -1:]], axis=2) - v
    return gx, gy, gz


def _sd_div(gx, gy, gz):
    div = np.empty_like(gx)
    div[1:-1] = gx[1:-1] - gx[:-2]
    div[0] = gx[0]
    div[-1] = -gx[-2]
    div[:, 1:-1] += gy[:, 1:-1] - gy[:, :-2]
    div[:, 0] += gy[:, 0]
    div[:, -1] += -gy[:, -2]
    div[:, :, 1:-1] += gz[:, :, 1:-1] - gz[:, :, :-2]
    div[:, :, 0] += gz[:, :, 0]
    div[:, :, -1] += -gz[:, :, -2]
    return div


def rumba_tv_oracle(vol, lam_vol, eps=1e-7):
    """TV multiplier for one component volume
    (reference: src/rusd.jl:183-235)."""
    gx, gy, gz = _sd_grad(vol)
    norm = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2 + eps)
    div = _sd_div(gx / norm, gy / norm, gz / norm)
    return 1.0 / (np.abs(1.0 - lam_vol * div) + eps)


def rumba_iterate_oracle(fodf, dodf, dodf_sig, sig2, lam_vol, signal,
                         kernel, ind_mask, shape3, n_order=1,
                         ipat_factor=1, use_tv=True, eps=1e-7):
    """One RUMBA-SD iteration (reference: src/rusd.jl:266-339).

    All matrices here are voxel-major [nmask, k] (the reference stores the
    transpose); ind_mask are flat C-order voxel indices into shape3.
    Returns the updated (fodf, dodf, dodf_sig, sig2, lam_vol).
    """
    ndir, ncomp = kernel.shape

    iratio = besseli_ratio_oracle(n_order, dodf_sig)

    rl_num = (signal * iratio) @ kernel
    rl_den = dodf @ kernel + eps
    rl = rl_num / rl_den

    if use_tv:
        tv = np.empty_like(fodf)
        nxyz = int(np.prod(shape3))
        for icomp in range(ncomp):
            vol = np.zeros(nxyz)
            vol[ind_mask] = fodf[:, icomp]
            tvv = rumba_tv_oracle(vol.reshape(shape3), lam_vol, eps)
            tv[:, icomp] = tvv.reshape(-1)[ind_mask]
    else:
        tv = 1.0

    fodf = np.maximum(fodf * rl * tv, 0.0)

    dodf = fodf @ kernel.T
    dodf_sig = (signal * dodf) / sig2

    resid = ((signal ** 2 + dodf ** 2) / 2 - (sig2 * dodf_sig) * iratio)
    sig2 = resid.sum(axis=1, keepdims=True) / (n_order * ndir)
    sig2 = np.clip(sig2, (1.0 / 80) ** 2, (1.0 / 8) ** 2)

    if use_tv:
        if ipat_factor == 1:
            lam_vol = np.full_like(lam_vol,
                                   max(sig2.mean(), (1.0 / 30) ** 2))
        else:
            flat = np.zeros(lam_vol.size)
            flat[ind_mask] = sig2[:, 0]
            lam_vol = flat.reshape(lam_vol.shape)

    return fodf, dodf, dodf_sig, sig2, lam_vol


# --------------------------------------------------------------------- #
# Structure tensor (reference: src/structens.jl:13-88)
# --------------------------------------------------------------------- #

def _conv1d_reflect_np(vol, k, axis):
    """Separable correlation with "reflect"/symmetric boundary, per
    ImageFiltering's imfilter(..., "reflect")."""
    r = (len(k) - 1) // 2
    pad = [(0, 0)] * vol.ndim
    pad[axis] = (r, r)
    v = np.pad(vol, pad, mode="symmetric")
    out = np.zeros_like(vol, dtype=np.float64)
    for i, w in enumerate(k):
        sl = [slice(None)] * vol.ndim
        sl[axis] = slice(i, i + vol.shape[axis])
        out += w * v[tuple(sl)]
    return out


def _gauss_kernel_np(sigma):
    r = int(4 * np.ceil(sigma)) // 2 * 2 // 2
    r = max(r, int(np.ceil(2 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-x * x / (2 * sigma * sigma))
    return k / k.sum()


_SCHARR_S = np.array([3.0, 10.0, 3.0]) / 16.0
_SCHARR_D = np.array([-0.5, 0.0, 0.5])


def _smooth_np(vol, sigma):
    k = _gauss_kernel_np(sigma)
    for ax in range(3):
        vol = _conv1d_reflect_np(vol, k, ax)
    return vol


def st_recon_oracle(vol, sigma, rho):
    """Structure tensor per the reference's pipeline (Gaussian pre-smooth,
    Scharr gradients, outer products, Gaussian post-smooth, per-voxel
    eigen, ascending) (reference: src/structens.jl:40-88)."""
    image = _smooth_np(np.asarray(vol, np.float64), sigma) if sigma > 0 \
        else np.asarray(vol, np.float64)

    grads = []
    for axis in range(3):
        g = image
        for ax in range(3):
            g = _conv1d_reflect_np(
                g, _SCHARR_D if ax == axis else _SCHARR_S, ax)
        grads.append(g)
    gx, gy, gz = grads

    comps = [gx * gx, gx * gy, gx * gz, gy * gy, gy * gz, gz * gz]
    if rho > 0:
        comps = [_smooth_np(c, rho) for c in comps]
    sxx, sxy, sxz, syy, syz, szz = comps

    shape = vol.shape
    evec = np.zeros(shape + (3, 3))
    eval_ = np.zeros(shape + (3,))
    for ix in range(shape[0]):
        for iy in range(shape[1]):
            for iz in range(shape[2]):
                S = np.array([
                    [sxx[ix, iy, iz], sxy[ix, iy, iz], sxz[ix, iy, iz]],
                    [sxy[ix, iy, iz], syy[ix, iy, iz], syz[ix, iy, iz]],
                    [sxz[ix, iy, iz], syz[ix, iy, iz], szz[ix, iy, iz]]])
                w, v = np.linalg.eigh(S)        # ascending, like Julia
                evec[ix, iy, iz] = v
                eval_[ix, iy, iz] = w
    return evec, eval_


# --------------------------------------------------------------------- #
# Deterministic streamline (reference: src/stream.jl:336-374, 501-541,
# 625-686)
# --------------------------------------------------------------------- #

def _pick_by_angle_oracle(vec_now, vecs_here):
    """(reference: src/stream.jl:340-374).  vecs_here [nvec, 3]."""
    cosang = np.empty(len(vecs_here))
    cosangabs = np.empty(len(vecs_here))
    for iv, v in enumerate(vecs_here):
        if not v.any():
            cosang[iv] = cosangabs[iv] = -np.inf
        else:
            cosang[iv] = float(vec_now @ v)
            cosangabs[iv] = abs(cosang[iv])
    ivec = int(np.argmax(cosangabs))
    if not np.isfinite(cosang[ivec]):
        return None
    v = vecs_here[ivec]
    return v.copy() if cosang[ivec] > 0 else -v.copy()


def stream_micro_line_oracle(seed_vox, ovecs, mask, search_dist,
                             search_ang=10.0, step_size=0.5,
                             ang_thresh=45.0, smooth_coeff=0.2,
                             len_max=None):
    """Bidirectional microscopy cone-search streamline from one seed
    (reference: src/stream.jl:547-619, driver 625-686).

    NB the reference's micro-specific defaults (step=1, ang=20, smooth=0)
    apply only when the caller passes `nothing` explicitly
    (src/stream.jl:88-92); the concrete kwarg defaults (0.5/45/0.2) win
    otherwise, and are the defaults here."""
    nx, ny, nz = mask.shape
    if len_max is None:
        len_max = max(nx, ny, nz)
    cosang_thresh = np.cos(np.radians(ang_thresh))
    search_cos = np.cos(np.radians(search_ang))
    rx, ry, rz = search_dist

    # window offsets within the (per-axis normalized) unit ball, center
    # excluded; direction = normalized per-axis-scaled offset
    offs, dirs = [], []
    for dx in range(-rx, rx + 1):
        for dy in range(-ry, ry + 1):
            for dz in range(-rz, rz + 1):
                rho = np.array([dx / (rx + 0.5) if rx else 0.0,
                                dy / (ry + 0.5) if ry else 0.0,
                                dz / (rz + 0.5) if rz else 0.0])
                r = np.linalg.norm(rho)
                if 0 < r < 1:
                    offs.append((dx, dy, dz))
                    dirs.append(rho / r)

    strline = []
    npts = 0
    for fwd in (1, -1):
        pos = np.asarray(seed_vox, float)
        iv = tuple(int(v) for v in np.asarray(seed_vox))
        vec = ovecs[iv][0].astype(float) * fwd

        addpt = (lambda p: strline.insert(0, p)) if fwd == 1 else \
            strline.append

        while True:
            nxt = np.round(pos + vec * step_size).astype(int)
            if not ((0 <= nxt[0] < nx) and (0 <= nxt[1] < ny)
                    and (0 <= nxt[2] < nz)):
                break
            if not mask[tuple(nxt)]:
                break

            best, bestabs, bestcell = None, -np.inf, None
            for (dx, dy, dz), d in zip(offs, dirs):
                c = (nxt[0] + dx, nxt[1] + dy, nxt[2] + dz)
                if not ((0 <= c[0] < nx) and (0 <= c[1] < ny)
                        and (0 <= c[2] < nz)):
                    continue
                if not mask[c] or float(vec @ d) <= search_cos:
                    continue
                ca = float(vec @ ovecs[c][0])
                if abs(ca) > bestabs:
                    best, bestabs, bestcell = ca, abs(ca), c
            if best is None or not np.isfinite(best):
                break

            v_next = ovecs[bestcell][0].astype(float)
            if best <= 0:
                v_next = -v_next

            addpt(pos.copy())
            npts += 1

            if float(vec @ v_next) < cosang_thresh:
                break
            if npts > len_max:
                break

            if smooth_coeff != 0:
                v_next = smooth_coeff * vec + (1 - smooth_coeff) * v_next
                v_next = v_next / np.linalg.norm(v_next)

            pos = np.asarray(bestcell, float)
            vec = v_next

    return np.asarray(strline).reshape(-1, 3)


def stream_line_oracle(seed_vox, sub_vox, ovecs, mask, step_size=0.5,
                       cosang_thresh=np.cos(np.radians(45.0)),
                       smooth_coeff=0.2, len_max=None):
    """Bidirectional deterministic streamline from one seed
    (reference: src/stream.jl:625-686).

    ovecs: [nx, ny, nz, nvec, 3]; mask: [nx, ny, nz] bool.
    Returns the [npts, 3] polyline (forward points prepended reversed,
    like the reference's prepend!/append!).
    """
    nx, ny, nz = mask.shape
    if len_max is None:
        len_max = max(nx, ny, nz)

    strline = []
    npts = 0
    for fwd in (1, -1):
        pos_now = np.asarray(seed_vox, float) + np.asarray(sub_vox, float)
        iv = tuple(int(v) for v in np.asarray(seed_vox))
        vec_now = ovecs[iv][0].astype(float) * fwd

        addpt = (lambda p: strline.insert(0, p)) if fwd == 1 else \
            strline.append

        while True:
            pos_next = pos_now + vec_now * step_size
            inext = np.round(pos_next).astype(int)
            if not ((0 <= inext[0] < nx) and (0 <= inext[1] < ny)
                    and (0 <= inext[2] < nz)):
                break
            if not mask[tuple(inext)]:
                break
            vec_next = _pick_by_angle_oracle(vec_now, ovecs[tuple(inext)])
            if vec_next is None:
                break

            addpt(pos_now.copy())
            npts += 1

            if float(vec_now @ vec_next) < cosang_thresh:
                break
            if npts > len_max:
                break

            if smooth_coeff != 0:
                vec_next = (smooth_coeff * vec_now
                            + (1 - smooth_coeff) * vec_next)
                vec_next = vec_next / np.linalg.norm(vec_next)

            pos_now = pos_next
            vec_now = vec_next

    return np.asarray(strline).reshape(-1, 3)
