"""HEVC CABAC context initValues (spec 9.3.2.2, Tables 9-5..9-32).

Rows are per initType: [0]=I-slice, [1]=P, [2]=B (spec initType
ordering). Values recovered from the system libx265's context
initialization data (contexts.cpp .rodata, adjacent to the exported
g_nextState symbol; x265 stores rows B,P,I — reordered here to
I,P,B) and cross-checked against independently-known spec anchors
(split_cu I = {139,141,157}, part_mode I ctx0 = 184 — the latter
already proven by bit-exact oracle decode of the PCM path). Every
element is further verified empirically: tests/test_h265.py decodes
streams exercising each element through libavcodec and requires
bit-exact reconstruction, so a wrong value here fails loudly.

Frozen copy of ceracoder_tpu_torch/codec/h265/ctx_tables.py, the port's host spec:
the benchmark's reference keeps its own copy so that it imports nothing
of the program it judges.
"""

import numpy as np

CNU = 154  # "context not used"

# -- coding tree / CU level -------------------------------------------------
SPLIT_CU_FLAG = [[139, 141, 157], [107, 139, 126], [107, 139, 126]]
CU_TRANSQUANT_BYPASS = [[154], [154], [154]]
SKIP_FLAG = [[CNU, CNU, CNU], [197, 185, 201], [197, 185, 201]]
PART_MODE = [[184, CNU, CNU, CNU], [154, 139, 154, 154],
             [154, 139, 154, 154]]
PRED_MODE = [[CNU], [149], [134]]
PREV_INTRA_LUMA_PRED = [[184], [154], [183]]
INTRA_CHROMA_PRED = [[63, 139], [152, 139], [152, 139]]

# -- inter prediction (spec Tables 9-13..9-18) ------------------------------
MERGE_FLAG = [[CNU], [110], [154]]
MERGE_IDX = [[CNU], [122], [137]]
MVP_FLAG = [[CNU], [168], [168]]
# abs_mvd_greater0_flag (ctx 0) / abs_mvd_greater1_flag (ctx 1)
MVD_GREATER = [[CNU, CNU], [140, 198], [169, 198]]
# inter_pred_idc: ctx 0..3 by coding-tree depth (bin 0), ctx 4 (bin 1)
INTER_PRED_IDC = [[CNU] * 5, [95, 79, 63, 31, 31], [95, 79, 63, 31, 31]]

# -- transform tree ---------------------------------------------------------
SPLIT_TRANSFORM = [[153, 138, 138], [124, 138, 94], [224, 167, 122]]
CBF_LUMA = [[111, 141], [153, 111], [153, 111]]
CBF_CHROMA = [[94, 138, 182, 154, 154], [149, 107, 167, 154, 154],
              [149, 92, 167, 154, 154]]
QT_ROOT_CBF = [[CNU], [79], [79]]
CU_QP_DELTA = [[154, 154, 154], [154, 154, 154], [154, 154, 154]]
TRANSFORM_SKIP = [[139, 139], [139, 139], [139, 139]]

# -- residual coding --------------------------------------------------------
# last_sig_coeff_{x,y}_prefix share one init row: 15 luma + 3 chroma
LAST_SIG_PREFIX = [
    [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
     111, 79, 108, 123, 63],
    [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
     94, 108, 123, 108],
    [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
     79, 108, 123, 93],
]
CODED_SUB_BLOCK = [[91, 171, 134, 141], [121, 140, 61, 154],
                   [121, 140, 61, 154]]
# sig_coeff_flag: 27 luma + 15 chroma contexts
SIG_COEFF = [
    [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
     153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
     125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
     136, 139, 111],
    [155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
     153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
     151, 183, 140],
    [170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
     153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
     154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
     151, 183, 140],
]
# coeff_abs_level_greater1: 4 luma ctx sets x 4 + 2 chroma sets x 4 = 24
GREATER1 = [
    [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
     122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
     121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
    [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
     121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
]
# coeff_abs_level_greater2: one per ctx set (4 luma + 2 chroma)
GREATER2 = [[138, 153, 136, 167, 152, 152], [107, 167, 91, 122, 107, 167],
            [107, 167, 91, 107, 107, 167]]

# SAO (spec Table 9-5/9-6)
SAO_MERGE = [[153], [153], [153]]
SAO_TYPE_IDX = [[200], [185], [160]]

# sig_coeff_flag ctxIdxMap for 4x4 TUs (spec 9.3.4.2.5)
SIG_CTX_MAP_4x4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7,
                            8, 8], np.int32)


_LAYOUT = [
    ("part_mode", PART_MODE),
    ("prev_intra", PREV_INTRA_LUMA_PRED),
    ("chroma_pred", INTRA_CHROMA_PRED),
    ("cbf_luma", CBF_LUMA),
    ("cbf_chroma", CBF_CHROMA),
    ("last_x", LAST_SIG_PREFIX),
    ("last_y", LAST_SIG_PREFIX),
    ("csbf", CODED_SUB_BLOCK),
    ("sig", SIG_COEFF),
    ("gr1", GREATER1),
    ("gr2", GREATER2),
    ("split_cu", SPLIT_CU_FLAG),
    # inter elements (CNU-initialized in I slices, unused there)
    ("skip", SKIP_FLAG),
    ("pred_mode", PRED_MODE),
    ("merge_flag", MERGE_FLAG),
    ("merge_idx", MERGE_IDX),
    ("mvp_flag", MVP_FLAG),
    ("mvd_gr", MVD_GREATER),
    ("rqt_root_cbf", QT_ROOT_CBF),
    ("inter_pred_idc", INTER_PRED_IDC),
    ("sao_merge", SAO_MERGE),
    ("sao_type", SAO_TYPE_IDX),
    ("split_tu", SPLIT_TRANSFORM),
]


def build_slice_contexts(qp: int, init_type: int):
    """Packed context states for a slice at the given QP and initType
    (spec 9.3.2.2: 0 = I, 1 = P, 2 = B), plus the offset of each
    element in the context array."""
    from benchmark.reference.hevc.cabac import init_context

    states = []
    offsets = {}
    for name, table in _LAYOUT:
        offsets[name] = len(states)
        states.extend(init_context(v, qp) for v in table[init_type])
    return np.array(states, np.uint8), offsets


