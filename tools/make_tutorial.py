"""Build and execute docs/tutorial.ipynb.

Mirrors the reference tutorial's flow (docs/tutorial.ipynb in Fibers.jl,
67 cells: mri_read -> info/show -> adc_fit -> dti_fit -> gqi_rec ->
rumba resume -> tractography) on a synthetic phantom with quantitative
asserts, so the notebook is runnable offline and self-checking.

Run: python tools/make_tutorial.py   (executes on CPU, writes the
executed notebook to docs/tutorial.ipynb)
"""

import os
import sys

import nbformat as nbf
from nbclient import NotebookClient

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def md(s):
    return nbf.v4.new_markdown_cell(s.strip())


def code(s):
    return nbf.v4.new_code_cell(s.strip())


CELLS = [
    md("""
# fibers_tpu tutorial

A diffusion-MRI pipeline in JAX, with the same user surface
as [Fibers.jl](https://github.com/lincbrain/Fibers.jl).  This notebook
mirrors the reference tutorial's flow end to end — volume I/O, ADC/DTI
fits, GQI ODFs, RUMBA-SD with resume, and deterministic tractography —
on a synthetic phantom with known ground truth, so every step is
quantitatively checked and runs offline on CPU in a few minutes.

On a GPU host the same code runs unchanged; the heavy stages (model
fits, streamline propagation) execute as batched XLA programs.
"""),
    code("""
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
jax.config.update("jax_platforms", "cpu")

import numpy as np
import fibers_tpu as ft

print("backend:", jax.default_backend())
"""),
    md("""
## 1. A synthetic DWI scan

The reference tutorial downloads an HCP scan (140x140x92 voxels, 198
volumes, b in {0, 1500, 3000}).  We synthesize a small brain-like
phantom with the same acquisition structure: an ellipsoidal mask, a
smooth single-fiber orientation field, a crossing-fiber slab, and
Rician-ish noise — so we know the ground truth everywhere.
"""),
    code("""
shape = (40, 40, 24)
ndir, nb0 = 64, 4
rng = np.random.default_rng(0)

x, y, z = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape],
                      indexing="ij")
mask = (x**2/0.81 + y**2/0.81 + z**2/0.92) < 1.0

# two b-shells on a spherical spiral
nsh = (ndir - nb0) // 2
i = np.arange(nsh)
phi = np.pi * (3 - np.sqrt(5.0)) * i
zz = 1 - 2*(i + 0.5)/nsh
r = np.sqrt(1 - zz*zz)
dirs = np.stack([r*np.cos(phi), r*np.sin(phi), zz], 1)
bval = np.concatenate([np.zeros(nb0), np.full(nsh, 1500.0),
                       np.full(ndir - nb0 - nsh, 3000.0)]).astype(np.float32)
bvec = np.concatenate([np.zeros((nb0, 3)), dirs,
                       dirs[:ndir - nb0 - nsh]]).astype(np.float32)

# smooth orientation field + crossing slab
th = 0.8*x + 1.3*y
ax1 = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
ax2 = np.stack([-ax1[..., 1], ax1[..., 0], ax1[..., 2]], -1)
lp, lt = 1.7e-3, 0.3e-3

def tensor_signal(axes):
    dots = np.einsum("xyzi,vi->xyzv", axes, bvec)
    return np.exp(-bval * (lt + (lp - lt) * dots**2))

cross = (np.abs(y) < 0.25) & (np.abs(z) < 0.4)
w = np.where(cross, 0.5, 0.0)[..., None]
vol = 100.0 * ((1 - w)*tensor_signal(ax1) + w*tensor_signal(ax2))

# three tissue classes, like the HCP scan's anatomical segmentation:
# a CSF-like "ventricle" (isotropic, fast diffusion), a gray-matter
# rim (isotropic, slow), and the anisotropic white-matter bulk
r2 = x**2 + y**2 + z**2
csf = mask & (((x + 0.25)**2 + y**2 + z**2 < 0.03)
              | ((x - 0.25)**2 + y**2 + z**2 < 0.03))
gm = mask & ~csf & (r2 > 0.55)
wm = mask & ~csf & ~gm
d_csf, d_gm = 3.0e-3, 0.8e-3
vol[csf] = 100.0 * np.exp(-bval * d_csf)[None, :]
vol[gm] = 100.0 * np.exp(-bval * d_gm)[None, :]

vol *= 10.0                 # s0=1000: SNR ~500, like a real scan's b0
vol = np.abs(vol + 2.0*rng.standard_normal(vol.shape)) * mask[..., None]
vol = vol.astype(np.float32)
print("DWI:", vol.shape, "masked voxels:", int(mask.sum()),
      f"(wm {wm.sum()}, gm {gm.sum()}, csf {csf.sum()})")
"""),
    md("""
## 2. The `MRI` container and file I/O

`MRI` mirrors the reference's struct: volume + geometry (vox2ras
matrices, voxel sizes) + DWI tables.  `mri_write`/`mri_read` handle
.nii/.nii.gz/.mgh/.mgz (plus Bruker directories) with byte-level parity
to the reference's readers, and write .bvals/.bvecs sidecars.
"""),
    code("""
dwi = ft.MRI(vol=vol)
dwi.vox2ras0 = np.diag([1.5, 1.5, 1.5, 1.0]).astype(np.float32)
dwi.volsize = np.asarray(shape)
dwi.width, dwi.height, dwi.depth = shape
dwi.nframes = ndir
dwi.set_geometry()
dwi.bval, dwi.bvec = bval, ft.normalize_bvecs(bvec)

maskm = ft.MRI.like(dwi, 1, np.float32)
maskm.vol = mask.astype(np.float32)

outdir = "tutorial_out"
os.makedirs(outdir, exist_ok=True)
ft.mri_write(dwi, f"{outdir}/dwi.nii.gz")
ft.mri_write(maskm, f"{outdir}/mask.mgz")

back = ft.mri_read(f"{outdir}/dwi")      # stem resolution + sidecars
assert np.allclose(back.vol, dwi.vol, atol=1e-3)
assert back.bval.shape == (ndir,) and back.bvec.shape == (ndir, 3)
print("round trip OK; voxel size:", back.volres)
"""),
    md("""
`info` summarizes a header like the reference's; `show_slice` renders a
slice with anatomical orientation labels.
"""),
    code("""
ft.info(back)
"""),
    code("""
import matplotlib
matplotlib.use("Agg")
ft.show_slice(back, plane="a", t=0)
"""),
    md("""
## 3. ADC fit

Log-linear least squares of `s(b) = s0 * exp(-b*d)` over the masked
voxels, as one batched solve (the reference loops per voxel).  The
reference tutorial checks the fitted diffusivity per tissue class of
the anatomical segmentation (ventricles > gray > white along the
fiber-normal average), fitting on the lower shell only — at b=3000 the
CSF signal is beneath the noise floor and the log-linear fit would be
Rician-biased.  Our phantom has known per-class ground truth, so the
check is quantitative.
"""),
    code("""
lo = bval <= 1500.0
dwi_lo = ft.MRI(vol=np.ascontiguousarray(back.vol[..., lo]))
dwi_lo.vox2ras0 = back.vox2ras0.copy()
dwi_lo.volsize = np.asarray(shape)
dwi_lo.width, dwi_lo.height, dwi_lo.depth = shape
dwi_lo.nframes = int(lo.sum())
dwi_lo.set_geometry()
dwi_lo.bval, dwi_lo.bvec = bval[lo], dwi.bvec[lo]

adc, s0 = ft.adc_fit(dwi_lo, maskm)

rows = [("ventricles (CSF)", csf, d_csf),
        ("cortical gray matter", gm, d_gm),
        ("white matter", wm, None)]
print(f"{'tissue':<24}{'mean ADC':>12}{'truth':>12}")
for name, sel, truth in rows:
    m_adc = float(adc.vol[sel].mean())
    t = f"{truth:.1e}" if truth else "(aniso)"
    print(f"{name:<24}{m_adc:>12.2e}{t:>12}")
    if truth:
        assert abs(m_adc - truth) < 0.25 * truth, (name, m_adc)

# CSF diffuses fastest, gray matter slowest of the isotropic classes
assert adc.vol[csf].mean() > adc.vol[wm].mean() > 0
assert adc.vol[csf].mean() > adc.vol[gm].mean()
"""),
    md("""
## 4. DTI fit

Weighted least-squares tensor fit + closed-form eigendecomposition,
giving eigenvalues/vectors and RD/MD/FA maps.  We check FA against the
phantom: high along the single-fiber region, reduced in the crossing
slab, and the principal eigenvector should align with the true fiber.
"""),
    code("""
dti = ft.dti_fit(back, maskm)

sel1 = wm & ~cross                       # single-fiber white matter
fa_single = dti.fa.vol[sel1]
print(f"FA (single-fiber WM): {fa_single.mean():.3f}  "
      f"GM: {dti.fa.vol[gm].mean():.3f}  CSF: {dti.fa.vol[csf].mean():.3f}")
assert fa_single.mean() > 0.6
assert dti.fa.vol[gm].mean() < 0.3 and dti.fa.vol[csf].mean() < 0.3

# principal eigenvector vs ground truth (up to sign)
v1 = dti.eigvec1.vol[sel1]
truth = ax1[sel1]
align = np.abs(np.einsum("ni,ni->n", v1, truth))
print(f"median |v1 . truth| = {np.median(align):.4f}")
assert np.median(align) > 0.98

ft.dti_write(dti, f"{outdir}/dti")
print("wrote", sorted(f for f in os.listdir(outdir) if "dti" in f)[:4], "...")
"""),
    md("""
## 5. GQI reconstruction

Generalized q-sampling on the 642-vertex sphere: one large GEMM
over the voxel batch plus face-neighbor peak NMS.  In the crossing slab
GQI should find two distinct peaks ~90 degrees apart.
"""),
    code("""
gqi = ft.gqi_rec(back, maskm, ft.sphere_642)

p1 = np.asarray(gqi.peak[0].vol)[sel1]
truth = ax1[sel1]
n1 = np.linalg.norm(p1, axis=1)
ok = n1 > 0
align = np.abs(np.einsum("ni,ni->n", p1[ok]/n1[ok, None], truth[ok]))
print(f"peak-1 angular agreement: median |dot| = {np.median(align):.4f}")
assert np.median(align) > 0.97

# crossing slab: second peak present and ~orthogonal to the first
p1c = np.asarray(gqi.peak[0].vol)[wm & cross]
p2c = np.asarray(gqi.peak[1].vol)[wm & cross]
both = (np.linalg.norm(p1c, 2, 1) > 0) & (np.linalg.norm(p2c, 2, 1) > 0)
print(f"crossing voxels with 2 peaks: {both.mean():.2f}")
assert both.mean() > 0.5
cosx = np.abs(np.einsum("ni,ni->n", p1c[both], p2c[both]))
cosx /= (np.linalg.norm(p1c[both], 2, 1) * np.linalg.norm(p2c[both], 2, 1))
print(f"median inter-peak |cos| = {np.median(cosx):.3f} (expect ~0)")
assert np.median(cosx) < 0.35
"""),
    md("""
## 6. DSI reconstruction

Diffusion spectrum imaging needs Cartesian q-space sampling (b scales
with |q|^2).  We synthesize a small DSI acquisition of the same
geometry — 123 q-space points in a radius-3 ball — and reconstruct the
diffusion propagator and its orientation distribution by batched 3D
real-FFT plus a radial-quadrature GEMM.
"""),
    code("""
r = np.arange(-3, 4)
qg = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
qg = qg[(qg**2).sum(1) <= 9].astype(np.float64)
qn = np.sqrt((qg**2).sum(1))
bvec_dsi = np.where(qn[:, None] > 0, qg/np.maximum(qn, 1e-30)[:, None],
                    0.0).astype(np.float32)
bval_dsi = ((qg**2).sum(1) * (6000.0/9)).astype(np.float32)
print(f"DSI: {len(bval_dsi)} q-space samples, bmax={bval_dsi.max():.0f}")

dots = np.einsum("xyzi,vi->xyzv", ax1, bvec_dsi)
vol_dsi = (100.0*np.exp(-bval_dsi*(lt + (lp - lt)*dots**2))).astype(np.float32)
vol_dsi = np.abs(vol_dsi + 2.0*rng.standard_normal(vol_dsi.shape)) \\
    * mask[..., None]
dwi_dsi = ft.MRI(vol=vol_dsi.astype(np.float32))
dwi_dsi.vox2ras0 = dwi.vox2ras0.copy()
dwi_dsi.volsize = np.asarray(shape)
dwi_dsi.width, dwi_dsi.height, dwi_dsi.depth = shape
dwi_dsi.nframes = len(bval_dsi)
dwi_dsi.set_geometry()
dwi_dsi.bval, dwi_dsi.bvec = bval_dsi, bvec_dsi

dsi = ft.dsi_rec(dwi_dsi, maskm, ft.sphere_362)
p1 = np.asarray(dsi.peak[0].vol)[sel1]
n1 = np.linalg.norm(p1, axis=1)
ok = n1 > 0
align = np.abs(np.einsum("ni,ni->n", p1[ok]/n1[ok, None], ax1[sel1][ok]))
print(f"DSI peak-1 agreement: median |dot| = {np.median(align):.4f}")
assert np.median(align) > 0.95
ft.dsi_write(dsi, f"{outdir}/dsi")
"""),
    md("""
## 7. RUMBA-SD with checkpoint/resume

Robust spherical deconvolution (Richardson-Lucy with a Rician noise
model and TV regularization).  The reference tutorial resumes from a
precomputed run via the field-per-file convention
(`mri_read(indir*"/rumba100", RUMBASD)`); we demonstrate both that and
in-loop checkpointing, which the reference does not have.
""" ),
    code("""
ck = f"{outdir}/rumba.ckpt.npz"
if os.path.exists(ck):
    os.remove(ck)

# run 30 iterations, checkpointing every 10
rumba30 = ft.rumba_rec(back, maskm, ft.sphere_362, niter=30,
                       checkpoint_path=ck, checkpoint_every=10)
ft.rumba_write(rumba30, f"{outdir}/rumba30")
print(f"SNR estimate after 30 iters: {rumba30.snr_mean:.1f}")
"""),
    code("""
# resume: a fresh call finds the checkpoint and continues
rumba60 = ft.rumba_rec(back, maskm, ft.sphere_362, niter=60,
                       checkpoint_path=ck, checkpoint_every=30)
print(f"SNR estimate after 60 iters: {rumba60.snr_mean:.1f}")
assert np.isfinite(rumba60.gfa.vol[mask]).all()
"""),
    code("""
# the reference's struct-resume convention: a result-struct type as the
# second argument of mri_read reads the field-per-file set back, exactly
# like the reference tutorial's  mri_read(indir*"/rumba100", RUMBASD)
from fibers_tpu import RUMBASD
rumba_back = ft.mri_read(f"{outdir}/rumba30", RUMBASD)
err = np.abs(rumba_back.gfa.vol - rumba30.gfa.vol).max()
print(f"struct round trip max |dGFA| = {err:.2e}")
assert err < 1e-5
"""),
    md("""
GFA (generalized fractional anisotropy, std/rms of the fODF) should
separate the tissue classes just like FA did for the tensor fit —
that is the quantitative spot check the reference tutorial performs on
its precomputed RUMBA run.
"""),
    code("""
gfa = np.asarray(rumba60.gfa.vol)
print(f"GFA  WM: {gfa[wm].mean():.3f}  GM: {gfa[gm].mean():.3f}  "
      f"CSF: {gfa[csf].mean():.3f}")
assert gfa[wm].mean() > 1.5 * gfa[gm].mean()
assert gfa[wm].mean() > 1.5 * gfa[csf].mean()

# the white-matter fraction map (1 - fGM - fCSF) should be high in the
# anisotropic bulk and low in the isotropic compartments
fwm = 1.0 - np.asarray(rumba60.fgm.vol) - np.asarray(rumba60.fcsf.vol)
print(f"fWM  WM: {fwm[wm].mean():.2f}  CSF: {fwm[csf].mean():.2f}")
assert fwm[wm].mean() > 0.6 and fwm[csf].mean() < 0.45
"""),
    md("""
## 8. Deterministic tractography

Streamlines follow the GQI peak field (FA-masked), integrated in
lockstep on device with 3 jittered sub-voxel seeds per voxel, and are
written as a TrackVis .trk file.
"""),
    code("""
tract = ft.stream(gqi.peak[0], fa=dti.fa, mask=maskm, nsub=3,
                  fa_thresh=0.1)
print(f"{tract.n_count} streamlines")
assert tract.n_count > 1000

ft.trk_write(tract, f"{outdir}/tract.trk")
t2 = ft.trk_read(f"{outdir}/tract.trk")
assert t2.n_count == tract.n_count
pts = np.asarray(t2.xyz[0])
print("first line:", pts.shape[1], "points")

# streamlines should follow the in-plane fiber field: small z drift
zdrift = [np.ptp(np.asarray(m)[2]) for m in t2.xyz[:200]]
print(f"median z-extent: {np.median(zdrift):.2f} voxels")
assert np.median(zdrift) < 2.0
"""),
    md("""
### Visualizing peaks and tracts

The standard direction-encoded view: GQI peak vectors as a quiver over
the FA map on the middle axial slice, and the tractogram projected onto
the same plane, each segment colored by its local direction
(|x|,|y|,|z| -> RGB).  In the crossing slab the quiver shows both
fiber populations.
"""),
    code("""
import matplotlib.pyplot as plt
from matplotlib.collections import LineCollection

zmid = shape[2] // 2
fig, axs = plt.subplots(1, 2, figsize=(11, 5))

# peak quiver over FA
fa_sl = np.asarray(dti.fa.vol)[:, :, zmid]
p1v = np.asarray(gqi.peak[0].vol)[:, :, zmid]
p2v = np.asarray(gqi.peak[1].vol)[:, :, zmid]
axs[0].imshow(fa_sl.T, origin="lower", cmap="gray", vmin=0, vmax=1)
s = 2                                     # plot every 2nd voxel
gx, gy = np.meshgrid(np.arange(0, shape[0], s),
                     np.arange(0, shape[1], s), indexing="ij")
for pv, col in ((p1v, "red"), (p2v, "cyan")):
    u, w = pv[::s, ::s, 0], pv[::s, ::s, 1]
    axs[0].quiver(gx, gy, u, w, color=col, scale=28, width=0.004,
                  headwidth=1, pivot="middle")
axs[0].set_title("GQI peaks 1 (red) + 2 (cyan) over FA")

# direction-colored tract projection
segs, cols = [], []
for m in t2.xyz[:1500]:
    p = np.asarray(m).T                   # [npts, 3] voxel coords
    if len(p) < 2:
        continue
    d = np.abs(np.diff(p, axis=0))
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    segs.extend(np.stack([p[:-1, :2], p[1:, :2]], axis=1))
    cols.extend(d)
axs[1].add_collection(LineCollection(segs, colors=cols, linewidths=0.4))
axs[1].set_xlim(0, shape[0]); axs[1].set_ylim(0, shape[1])
axs[1].set_aspect("equal")
axs[1].set_title(f"{t2.n_count} streamlines, direction-colored")
fig.savefig(f"{outdir}/peaks_tracts.png", dpi=80)
print(f"rendered {len(segs)} segments -> {outdir}/peaks_tracts.png")
assert len(segs) > 5000
plt.close(fig)
"""),
    md("""
## 9. RUMBA fODF peaks -> tractography

RUMBA's peak vectors carry the fiber volume fraction in their magnitude;
`ft.peaks_to_ovecs` splits them into unit directions plus `f` amplitude
volumes, which `stream` thresholds at `f_thresh`.  With `device=True`
the peak field never leaves the accelerator: `stream` builds its masked
orientation array on device (the production path on a GPU).
"""),
    code("""
ovecs, fs = ft.peaks_to_ovecs(rumba60)
tract_r = ft.stream(ovecs, f=fs, mask=maskm, nsub=1, f_thresh=0.01)
print(f"{tract_r.n_count} streamlines from the RUMBA peak field")
assert tract_r.n_count > 500

pk = ft.peaks_to_ovecs(rumba60, device=True)       # zero-fetch handoff
tract_d = ft.stream(pk, mask=maskm, nsub=1, f_thresh=0.01)
assert tract_d.n_count == tract_r.n_count
print("device handoff: identical", tract_d.n_count, "streamlines")
"""),
    md("""
## 10. Probabilistic tractography (LCM)

With local connection matrices (`lcms=`), propagation samples each
voxel's 10 in-plane edge-pair connection strengths instead of greedily
following the vector field (reference: src/stream.jl:380-495).  Here we
open only the straight-through x connection, so every sampled path runs
along x.
"""),
    code("""
shape_l = (16, 16, 1)
v = np.zeros(shape_l + (3,), np.float32); v[..., 0] = 1.0
ov_l = ft.MRI(vol=v)
ov_l.vox2ras0 = np.eye(4, dtype=np.float32)
ov_l.volsize = np.asarray(shape_l)
ov_l.width, ov_l.height, ov_l.depth = shape_l
ov_l.nframes = 3
ov_l.set_geometry()

def _m(arr):
    m = ft.MRI.like(ov_l, 1, np.float32); m.vol = arr.astype(np.float32)
    return m

mask_l = np.zeros(shape_l, np.float32); mask_l[:, 8, 0] = 1
seed_l = np.zeros(shape_l, np.float32); seed_l[8, 8, 0] = 1
lcm = np.zeros(shape_l + (10,), np.float32)
lcm[..., 2] = 1.0                       # x straight-through edge pair
tract_l = ft.stream(ov_l, mask=_m(mask_l), seed=_m(seed_l),
                    lcms=ft.MRI(vol=lcm), nsub=0, step_size=1.0,
                    len_max=100)
pts_l = tract_l.xyz[0].T
print(f"LCM path: {pts_l.shape[0]} points, y spread "
      f"{np.ptp(pts_l[:, 1]):.2f}")
assert np.ptp(pts_l[:, 0]) > 10 and np.allclose(pts_l[:, 1], 8, atol=0.5)
assert tract_l.n_scalars == 1           # method-difference flags
"""),
    md("""
## 11. Microscopy tractography

Voxel sizes <= 50 um switch `stream` into the cone-search regime
(reference: src/stream.jl:83-92, 547-619): each step scans a search
window around the tentative next voxel for the best-aligned orientation
within `search_ang` degrees, jumping voxel to voxel.
"""),
    code("""
shape_u = (30, 9, 9)
v = np.zeros(shape_u + (3,), np.float32); v[..., 0] = 1.0
ov_u = ft.MRI(vol=v)
ov_u.vox2ras0 = np.eye(4, dtype=np.float32)
ov_u.volsize = np.asarray(shape_u)
ov_u.width, ov_u.height, ov_u.depth = shape_u
ov_u.nframes = 3
ov_u.set_geometry()
ov_u.volres = np.array([0.01, 0.01, 0.01], np.float32)   # 10 um voxels

mask_u = np.zeros(shape_u, np.float32); mask_u[:, 4, 4] = 1
seed_u = np.zeros(shape_u, np.float32); seed_u[15, 4, 4] = 1
mu = ft.MRI.like(ov_u, 1, np.float32); mu.vol = mask_u
su = ft.MRI.like(ov_u, 1, np.float32); su.vol = seed_u
tract_u = ft.stream(ov_u, mask=mu, seed=su, nsub=0, search_dist=3,
                    len_max=100)
pts_u = tract_u.xyz[0].T
print(f"micro path: {pts_u.shape[0]} integer-voxel jumps along x")
assert np.ptp(pts_u[:, 0]) > 20
"""),
    md("""
## 12. Terminal display and the FreeSurfer color LUT

`vol_to_rgb` auto-detects what a volume is (segmentation IDs, unit
vector map, or grayscale) and colors it accordingly; segmentations use
the bundled FreeSurfer color table (`ft.color_lut`, reference:
src/show.jl:16-99).  `disp` renders the middle slice as ANSI half-block
art with optional intensity modulation — handy over ssh.
"""),
    code("""
seg = np.zeros(shape, np.float32)
seg[wm], seg[gm], seg[csf] = 2, 3, 4     # FreeSurfer aseg label ids
rgb, kind = ft.vol_to_rgb(seg)
print("detected:", kind, rgb.shape)
assert kind == "segmentation"
for i in (2, 3, 4):
    j = int(np.searchsorted(ft.color_lut.id, i))
    print(f"  {i}: {ft.color_lut.name[j]}  rgb={ft.color_lut.rgb[j]}")

# vector maps are detected by unit norm along a size-3 axis
rgbv, kindv = ft.vol_to_rgb(np.asarray(dti.eigvec1.vol) * mask[..., None])
assert kindv == "vector"
print("eigvec map detected as:", kindv)
"""),
    code("""
segm = ft.MRI.like(dwi, 1, np.float32)
segm.vol = seg[..., None]
meanm = ft.MRI.like(dwi, 1, np.float32)
meanm.vol = back.vol.mean(-1, keepdims=True)
ft.disp(segm, meanm)                     # alpha-blended, b0-modulated
"""),
    md("""
## 13. Registration transforms and tract manipulation

`Xform` mirrors the reference's transform container (read from
FreeSurfer .lta or FSL .mat files with `ft.xfm_read` /
`ft.xfm_read_mat`); `xfm_apply`/`xfm_rotate`/`xfm_compose`/`xfm_inv`
operate on points, and `str_xform` carries a whole tractogram into a
target volume's space, rewriting its geometry header
(reference: src/trk.jl:316-347).  `str_add`/`str_merge` edit and
concatenate tractograms.
"""),
    code("""
from fibers_tpu import Xform, xfm_apply, xfm_inv, xfm_compose

# an upsampling vox2vox transform into a 2x finer grid
up = Xform()
up.insize, up.outsize = np.asarray(shape), np.asarray(shape) * 2
up.inres, up.outres = dwi.volres, dwi.volres / 2
up.invox2ras = dwi.vox2ras0.copy()
up.outvox2ras = (dwi.vox2ras0 @ np.diag([0.5, 0.5, 0.5, 1.0])) \\
    .astype(np.float32)
up.vox2vox = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)

pts = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]], np.float32)
assert np.allclose(xfm_apply(up, pts), pts * 2)
assert np.allclose(xfm_apply(xfm_compose(xfm_inv(up), up), pts), pts)

tract_up = ft.str_xform(up, tract)
assert tract_up.n_count == tract.n_count
assert np.allclose(np.asarray(tract_up.xyz[0]),
                   np.asarray(tract.xyz[0]) * 2, atol=1e-4)
print("str_xform: header dims", tract.dim, "->", tract_up.dim,
      "voxel size", tract_up.voxel_size)
"""),
    code("""
# str_merge concatenates; str_add appends hand-built lines
both = ft.str_merge(tract, tract_r)
assert both.n_count == tract.n_count + tract_r.n_count
line = np.array([[1, 1, 1], [2, 1, 1], [3, 1, 1]], np.float32).T
ft.str_add(both, [line])
print(f"merged {tract.n_count} + {tract_r.n_count} (+1 manual) "
      f"= {both.n_count} streamlines")
"""),
    md("""
## 14. Multi-chip fits

Every fit takes a prepared `VoxelBatch`; preparing it on a
`jax.sharding.Mesh` makes the same calls data-parallel across every
device (here: the virtual CPU devices of this notebook kernel — on a
multi-GPU host the same two lines shard over the GPUs).  RUMBA's TV regularizer
reshards over fODF components internally so its stencils stay
device-local.
"""),
    code("""
import jax
from fibers_tpu.parallel.mesh import make_mesh

if len(jax.devices()) > 1:
    mesh = make_mesh()
    batch = ft.prepare_batch(dwi, maskm, mesh=mesh)
    dti_sharded = ft.dti_fit(dwi, maskm, batch=batch)
    err = np.abs(np.asarray(dti_sharded.fa.vol)
                 - np.asarray(dti.fa.vol)).max()
    print(f"{len(jax.devices())}-device mesh: max |dFA| = {err:.2e}")
    assert err < 1e-4
else:
    print("single device - mesh demo skipped")
"""),
    md("""
## 15. Bruker scanner directories

`mri_read` on a directory parses Bruker ParaVision scans: the `method`
/ `acqp` / `reco` text headers plus the raw `2dseq` image, restoring
per-frame RECO slope/offset scaling and receiver-gain normalization,
and reading the diffusion table (with the b=0 image prepended) from the
method file (reference: src/mri.jl:812-1189).
"""),
    code("""
root = f"{outdir}/bruker_scan"
os.makedirs(f"{root}/pdata/1", exist_ok=True)
nx, ny, nz, nfr = 8, 6, 4, 3
with open(f"{root}/method", "w") as f:
    f.write("##$PVM_SpatResol=( 3 )\\n0.1 0.1 0.2\\n"
            f"##$PVM_Matrix=( 3 )\\n{nx} {ny} {nz}\\n"
            "##$EchoTime=25.0\\n##$PVM_RepetitionTime=500.0\\n"
            "##$PVM_DwAoImages=1\\n"
            "##$PVM_DwDir=( 2, 3 )\\n1 0 0 0 1 0\\n"
            "##$PVM_DwEffBval=( 3 )\\n5 1000 1000\\n")
with open(f"{root}/acqp", "w") as f:
    f.write("##$RG=128.0\\n")
with open(f"{root}/pdata/1/reco", "w") as f:
    f.write("##$RECO_image_type=MAGNITUDE_IMAGE\\n"
            "##$RECO_wordtype=_16BIT_SGN_INT\\n"
            "##$RECO_map_offset=( 3 )\\n0.0 1.0 2.0\\n"
            "##$RECO_map_slope=( 3 )\\n2.0 4.0 8.0\\n"
            "##$RECO_byte_order=littleEndian\\n")
raw = rng.integers(1, 1000, (nx, ny, nz, nfr)).astype("<i2")
with open(f"{root}/pdata/1/2dseq", "wb") as f:
    f.write(raw.tobytes(order="F"))

bru = ft.mri_read(root)
print("Bruker read:", bru.vol.shape, "te/tr:", bru.te, bru.tr)
print("b-values:", bru.bval, " voxel size:", bru.volres)
expect = raw / np.array([2.0, 4.0, 8.0]) + np.array([0.0, 1.0, 2.0])
assert np.allclose(bru.vol, expect / (128.0 / 64.0), rtol=1e-5)
assert np.allclose(bru.bvec[0], 0)       # prepended b=0 direction
"""),
    md("""
## 16. Where to go from here

- `ft.st_recon` — structure-tensor orientation for microscopy volumes
  (`lazy=True` keeps the eigenfields on device)
- `ft.xfm_read` / `ft.str_xform` — applying registration transforms to
  volumes and tractograms
- `ft.rumba_rec(..., batch=prepare_batch(..., mesh=mesh))` and
  `ft.stream(..., mesh=mesh)` scale the heavy fits and tractography
  across several devices; see `fibers_tpu/parallel/` and docs/parity.md.
- `benchmarks/` — e2e, per-model, kernel-rate and CPU-baseline
  benchmarks; configurations in BASELINE.md, measurements in PERF.md.
"""),
]


def main():
    nb = nbf.v4.new_notebook()
    nb.cells = CELLS
    nb.metadata["kernelspec"] = {
        "name": "python3", "display_name": "Python 3",
        "language": "python"}

    client = NotebookClient(nb, timeout=1200,
                            resources={"metadata": {"path": "/tmp"}})
    client.execute()

    out = os.path.join(HERE, "docs", "tutorial.ipynb")
    with open(out, "w") as f:
        nbf.write(nb, f)
    print("wrote", out)


if __name__ == "__main__":
    main()
