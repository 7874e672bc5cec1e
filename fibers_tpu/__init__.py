"""fibers_tpu — a diffusion-MRI pipeline in JAX.

Built from scratch with the capabilities and public API surface of
lincbrain/Fibers.jl: byte-faithful volume/tractogram I/O on the host, and
all reconstruction math (DTI, GQI, DSI, RUMBA-SD, structure tensor) plus
streamline tractography as batched, jitted XLA computations over the
brain mask, shardable across a device mesh.

Public API mirrors the reference's exported names (see SURVEY.md §2).
"""

from .core.mri import MRI, NIfTIHeader

# Reference-spelling alias (Fibers.jl exports `NIfTIheader`)
NIfTIheader = NIfTIHeader
from .core.odf import ODF, half_sphere
from .core.geometry import (vox2ras_0to1, vox2ras_tkreg, vox2ras_to_qform,
                            vox2ras_to_orient)
from .core.xform import (Xform, xfm_read, xfm_read_mat, xfm_compose,
                         xfm_apply, xfm_rotate, xfm_inv)
from .io.filename import get_tmp_path, mri_filename
from .io.dispatch import mri_read, mri_write, mri_read_struct, mri_write_struct
from .io.btables import mri_read_bfiles, mri_read_bfiles_into, normalize_bvecs
from .io.mgh import load_mgh, save_mgh
from .io.nifti import load_nifti, load_nifti_hdr, save_nifti
from .io.bruker import load_bruker
from .io.trk import Tract, trk_read, trk_write, str_add, str_merge, str_xform
from .utils.coords import (cart2pol, pol2cart, cart2sph, sph2cart, ang2rot,
                           isinmask)


# Sphere tessellations load lazily (data files)
def __getattr__(name):
    if name in ("sphere_362", "sphere_642", "sphere_724"):
        from .core import odf as _odf
        return getattr(_odf, name)
    if name in ("DTI", "adc_fit", "dti_fit", "dti_fit_ls", "dti_maps",
                "dti_write"):
        from .models import dti as _m
        return getattr(_m, name)
    if name in ("GQI", "gqi_rec", "gqi_write", "find_peaks"):
        from .models import gqi as _m
        return getattr(_m, name)
    if name in ("DSI", "dsi_rec", "dsi_write"):
        from .models import dsi as _m
        return getattr(_m, name)
    if name in ("RUMBASD", "rumba_rec", "rumba_write", "rumba_peaks",
                "tensor_model", "besseli_ratio"):
        from .models import rumba as _m
        return getattr(_m, name)
    if name in ("st_recon", "st_eigen"):
        from .models import structens as _m
        return getattr(_m, name)
    if name in ("stream", "StreamConfig", "StreamWork", "stream_new_line",
                "stream_new_point", "stream_micro_new_point",
                "peaks_to_ovecs"):
        from .tract import stream as _m
        return getattr(_m, name)
    if name in ("LUT", "color_lut", "info", "disp", "show_slice",
                "vol_to_rgb", "view_axes"):
        from .viz import show as _m
        return getattr(_m, name)
    if name == "show":
        # the reference overloads Base.show for slice views
        from .viz.show import show_slice as _s
        return _s
    if name == "view":
        from .viz.view import view as _v
        return _v
    if name in ("VoxelBatch", "prepare_batch"):
        from .core import batch as _m
        return getattr(_m, name)
    raise AttributeError(name)


__version__ = "0.1.0"
