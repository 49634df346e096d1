"""Test fixture: a miniature AV1 bitstream builder.

Composes spec-valid sequence/frame OBUs bit by bit so parser tests can
assert exact consumption and round-trip behavior without external
encoders (same role as the reference's BitBuilder fixtures,
frame.rs:2018-2117, but able to emit whole temporal units / IVF files).

The emitted streams use a deliberately minimal feature profile:
profile 0, no order hints, no superres/cdef/restoration, single tile.
Frames carry dummy tile payloads — header parsers never descend into
tile data, and fixture streams are additionally validated against real
encoder output in the shim-backed tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from grav1synth.bitio import BitWriter, leb128_encode
from grav1synth.container.ivf import IvfHeader, IvfPacket
from grav1synth.obu.grain import write_film_grain_params
from grav1synth.obu.types import ColorConfig, FilmGrainParams, FrameType


@dataclass
class MiniSeqConfig:
    width: int = 64
    height: int = 64
    film_grain_params_present: bool = False
    bit_depth: int = 8
    monochrome: bool = False
    # operating_point_idc[0]: bits 0-7 temporal-layer mask, 8-11 spatial
    # (0 = applies to all layers; nonzero enables OBU layer filtering)
    op_idc: int = 0


def build_obu(obu_type: int, payload: bytes, extension=None) -> bytes:
    """Wrap a payload with an OBU header + leb128 size.

    ``extension``: optional (temporal_id, spatial_id) — emits the
    obu_extension_flag and extension byte (scalable streams)."""
    if extension is None:
        header = bytes([(obu_type << 3) | 0x02])  # has_size_field=1
    else:
        tid, sid = extension
        header = bytes(
            [(obu_type << 3) | 0x04 | 0x02, (tid << 5) | (sid << 3)]
        )
    return header + leb128_encode(len(payload)) + payload


def build_temporal_delimiter() -> bytes:
    return build_obu(2, b"")


def build_sequence_header(cfg: MiniSeqConfig) -> bytes:
    w = BitWriter()
    profile = 0 if cfg.bit_depth == 8 or cfg.bit_depth == 10 else 2
    w.put(profile, 3)  # seq_profile
    w.put(0, 1)  # still_picture
    w.put(0, 1)  # reduced_still_picture_header
    w.put(0, 1)  # timing_info_present_flag
    w.put(0, 1)  # initial_display_delay_present_flag
    w.put(0, 5)  # operating_points_cnt_minus_1
    w.put(cfg.op_idc, 12)  # operating_point_idc[0]
    w.put(0, 5)  # seq_level_idx[0]  (<=7: no seq_tier)
    w.put(15, 4)  # frame_width_bits_minus_1
    w.put(15, 4)  # frame_height_bits_minus_1
    w.put(cfg.width - 1, 16)  # max_frame_width_minus_1
    w.put(cfg.height - 1, 16)  # max_frame_height_minus_1
    w.put(0, 1)  # frame_id_numbers_present_flag
    w.put(1, 1)  # use_128x128_superblock
    w.put(0, 1)  # enable_filter_intra
    w.put(0, 1)  # enable_intra_edge_filter
    w.put(0, 1)  # enable_interintra_compound
    w.put(0, 1)  # enable_masked_compound
    w.put(0, 1)  # enable_warped_motion
    w.put(0, 1)  # enable_dual_filter
    w.put(0, 1)  # enable_order_hint
    w.put(0, 1)  # seq_choose_screen_content_tools
    w.put(0, 1)  # seq_force_screen_content_tools = 0
    # force_integer_mv not coded (force_screen_content_tools == 0)
    w.put(0, 1)  # enable_superres
    w.put(0, 1)  # enable_cdef
    w.put(0, 1)  # enable_restoration
    # color_config
    w.put(1 if cfg.bit_depth > 8 else 0, 1)  # high_bitdepth
    w.put(1 if cfg.monochrome else 0, 1)  # mono_chrome
    w.put(0, 1)  # color_description_present_flag
    if cfg.monochrome:
        w.put(0, 1)  # color_range
    else:
        w.put(0, 1)  # color_range
        # profile 0 -> 4:2:0, chroma_sample_position coded
        w.put(0, 2)  # chroma_sample_position
        w.put(0, 1)  # separate_uv_delta_q
    w.put(1 if cfg.film_grain_params_present else 0, 1)
    w.align_trailing_bits()
    return build_obu(1, w.getvalue())


def _color_config_of(cfg: MiniSeqConfig) -> ColorConfig:
    return ColorConfig(
        bit_depth=cfg.bit_depth,
        num_planes=1 if cfg.monochrome else 3,
        subsampling=(1, 1),
    )


def build_frame(
    cfg: MiniSeqConfig,
    frame_type: FrameType,
    grain: Optional[FilmGrainParams] = None,
    grain_disabled_bit: bool = False,
    tile_payload: bytes = b"\x00\x01\x02\x03",
    show_frame: bool = True,
    extension=None,
) -> bytes:
    """Build a Frame OBU (header + single tile group).

    ``grain``/``grain_disabled_bit`` control the grain syntax: params,
    an explicit apply_grain=0 bit, or (both unset) no grain syntax —
    which is only valid when cfg.film_grain_params_present is False.
    """
    w = BitWriter()
    w.put(0, 1)  # show_existing_frame
    w.put(int(frame_type), 2)
    w.put(1 if show_frame else 0, 1)
    if not show_frame:
        w.put(1, 1)  # showable_frame
    if not (
        frame_type == FrameType.SWITCH
        or (frame_type == FrameType.KEY and show_frame)
    ):
        w.put(0, 1)  # error_resilient_mode
    w.put(1, 1)  # disable_cdf_update
    # allow_screen_content_tools not coded (seq forces 0)
    # current_frame_id not coded
    w.put(0, 1)  # frame_size_override_flag
    # order_hint: 0 bits
    if not frame_type.is_intra:
        w.put(0, 3)  # primary_ref_frame
    if not (
        frame_type == FrameType.SWITCH
        or (frame_type == FrameType.KEY and show_frame)
    ):
        w.put(1, 8)  # refresh_frame_flags
    if frame_type.is_intra:
        # frame_size: no bits (no override, no superres)
        w.put(0, 1)  # render_and_frame_size_different
    else:
        # enable_order_hint=0: no frame_refs_short_signaling bit
        for _ in range(7):
            w.put(0, 3)  # ref_frame_idx[i]
        w.put(0, 1)  # render_and_frame_size_different
        w.put(0, 1)  # allow_high_precision_mv (force_integer_mv == 0)
        w.put(1, 1)  # is_filter_switchable
        w.put(0, 1)  # is_motion_mode_switchable
        # use_ref_frame_mvs not coded (enable_ref_frame_mvs=0)
    # disable_frame_end_update_cdf not coded (disable_cdf_update=1)
    w.put(1, 1)  # uniform_tile_spacing_flag (single sb -> no more bits)
    w.put(100, 8)  # base_q_idx
    w.put(0, 1)  # delta_q_y_dc coded=0
    if not cfg.monochrome:
        w.put(0, 1)  # delta_q_u_dc
        w.put(0, 1)  # delta_q_u_ac
    w.put(0, 1)  # using_qmatrix
    w.put(0, 1)  # segmentation_enabled
    w.put(0, 1)  # delta_q_present
    # loop filter
    w.put(0, 6)  # level[0]
    w.put(0, 6)  # level[1]
    # levels are 0: no level[2]/[3]
    w.put(0, 3)  # sharpness
    w.put(0, 1)  # loop_filter_delta_enabled
    # cdef/lr: disabled at sequence level
    w.put(0, 1)  # tx_mode_select
    if not frame_type.is_intra:
        w.put(0, 1)  # reference_select
    # skip mode not allowed; allow_warped not coded
    w.put(0, 1)  # reduced_tx_set
    if not frame_type.is_intra:
        for _ in range(7):
            w.put(0, 1)  # is_global[ref]
    # film grain
    if grain is not None:
        assert cfg.film_grain_params_present
        write_film_grain_params(w, grain, frame_type, _color_config_of(cfg))
    elif grain_disabled_bit:
        assert cfg.film_grain_params_present
        w.put(0, 1)  # apply_grain = 0
    w.byte_align(0)
    payload = w.getvalue() + tile_payload
    return build_obu(6, payload, extension=extension)


def sample_grain_params(seed: int = 7391) -> FilmGrainParams:
    """A representative parameter set exercising luma+chroma, lag 2."""
    p = FilmGrainParams(
        grain_seed=seed,
        scaling_points_y=[(0, 20), (40, 35), (120, 30), (255, 25)],
        scaling_points_cb=[(0, 10), (255, 12)],
        scaling_points_cr=[(0, 8), (128, 16)],
        scaling_shift=8,
        ar_coeff_lag=2,
        ar_coeffs_y=[3, -2, 5, 1, -7, 4, 2, -1, 6, 0, -3, 2],
        ar_coeffs_cb=[1, 0, -1, 2, 3, -2, 1, 0, -4, 2, 1, -1, 5],
        ar_coeffs_cr=[-2, 1, 0, -1, 2, 1, -3, 2, 0, 1, -2, 3, -6],
        ar_coeff_shift=6,
        cb_mult=128,
        cb_luma_mult=192,
        cb_offset=256,
        cr_mult=130,
        cr_luma_mult=190,
        cr_offset=250,
        chroma_scaling_from_luma=False,
        grain_scale_shift=0,
        overlap_flag=True,
        clip_to_restricted_range=False,
    )
    return p


def build_stream(
    cfg: MiniSeqConfig,
    frames: List[dict],
) -> List[IvfPacket]:
    """Build one packet per frame; the first packet carries the sequence
    header. ``frames`` entries are kwargs for build_frame plus
    'frame_type'."""
    packets = []
    for i, fr in enumerate(frames):
        fr = dict(fr)
        frame_type = fr.pop("frame_type", FrameType.KEY if i == 0 else FrameType.INTER)
        data = build_temporal_delimiter()
        if i == 0:
            data += build_sequence_header(cfg)
        data += build_frame(cfg, frame_type, **fr)
        packets.append(IvfPacket(pts=i, data=data))
    return packets


def default_ivf_header(cfg: MiniSeqConfig, nframes: int) -> IvfHeader:
    return IvfHeader(
        width=cfg.width,
        height=cfg.height,
        timebase_den=30,
        timebase_num=1,
        frame_count=nframes,
    )


def build_sequence_header_ext(
    cfg: MiniSeqConfig,
    enable_superres: bool = False,
    frame_id_numbers: bool = False,
    enable_order_hint: bool = False,
    order_hint_bits: int = 7,
) -> bytes:
    """Sequence header with optional rarely-exercised features."""
    w = BitWriter()
    w.put(0, 3)  # seq_profile
    w.put(0, 1)  # still_picture
    w.put(0, 1)  # reduced_still_picture_header
    w.put(0, 1)  # timing_info_present_flag
    w.put(0, 1)  # initial_display_delay_present_flag
    w.put(0, 5)  # operating_points_cnt_minus_1
    w.put(0, 12)  # operating_point_idc[0]
    w.put(0, 5)  # seq_level_idx[0]
    w.put(15, 4)  # frame_width_bits_minus_1
    w.put(15, 4)  # frame_height_bits_minus_1
    w.put(cfg.width - 1, 16)
    w.put(cfg.height - 1, 16)
    w.put(1 if frame_id_numbers else 0, 1)
    if frame_id_numbers:
        w.put(5, 4)  # delta_frame_id_length_minus_2 (=> 7 bits)
        w.put(2, 3)  # additional_frame_id_length_minus_1 (id_len = 10)
    w.put(1, 1)  # use_128x128_superblock
    w.put(0, 1)  # enable_filter_intra
    w.put(0, 1)  # enable_intra_edge_filter
    w.put(0, 1)  # enable_interintra_compound
    w.put(0, 1)  # enable_masked_compound
    w.put(0, 1)  # enable_warped_motion
    w.put(0, 1)  # enable_dual_filter
    w.put(1 if enable_order_hint else 0, 1)
    if enable_order_hint:
        w.put(0, 1)  # enable_jnt_comp
        w.put(0, 1)  # enable_ref_frame_mvs
    w.put(0, 1)  # seq_choose_screen_content_tools
    w.put(0, 1)  # seq_force_screen_content_tools = 0
    if enable_order_hint:
        w.put(order_hint_bits - 1, 3)
    w.put(1 if enable_superres else 0, 1)
    w.put(0, 1)  # enable_cdef
    w.put(0, 1)  # enable_restoration
    w.put(0, 1)  # high_bitdepth
    w.put(0, 1)  # mono_chrome
    w.put(0, 1)  # color_description_present_flag
    w.put(0, 1)  # color_range
    w.put(0, 2)  # chroma_sample_position
    w.put(0, 1)  # separate_uv_delta_q
    w.put(1 if cfg.film_grain_params_present else 0, 1)
    w.align_trailing_bits()
    return build_obu(1, w.getvalue())


def build_frame_ext(
    cfg: MiniSeqConfig,
    frame_type: FrameType = FrameType.KEY,
    grain: Optional[FilmGrainParams] = None,
    grain_disabled_bit: bool = False,
    enable_superres: bool = False,
    use_superres: bool = False,
    coded_denom: int = 3,
    frame_size_override: bool = False,
    override_dims: Optional[tuple] = None,
    render_size_different: bool = False,
    render_dims: tuple = (100, 80),
    frame_id_numbers: bool = False,
    enable_order_hint: bool = False,
    order_hint_bits: int = 7,
    order_hint: int = 0,
    segmentation: bool = False,
    delta_q: bool = False,
    lf_deltas: bool = False,
    tile_payload: bytes = b"\x00\x01\x02\x03",
) -> bytes:
    """Frame OBU exercising rarely-hit uncompressed_header branches.

    Only intra (KEY) and the simple INTER path are supported; the
    feature flags must match the sequence header that precedes it."""
    w = BitWriter()
    w.put(0, 1)  # show_existing_frame
    w.put(int(frame_type), 2)
    w.put(1, 1)  # show_frame
    if not (frame_type == FrameType.KEY or frame_type == FrameType.SWITCH):
        w.put(0, 1)  # error_resilient_mode
    w.put(1, 1)  # disable_cdf_update
    if frame_id_numbers:
        w.put(123, 10)  # current_frame_id (id_len = 10)
    if frame_type != FrameType.SWITCH:  # SWITCH: override implied 1
        w.put(1 if frame_size_override else 0, 1)
    if enable_order_hint:
        w.put(order_hint, order_hint_bits)
    # SWITCH implies error_resilient -> primary_ref not coded
    if not frame_type.is_intra and frame_type != FrameType.SWITCH:
        w.put(0, 3)  # primary_ref_frame
    if frame_type not in (FrameType.KEY, FrameType.SWITCH):
        w.put(1, 8)  # refresh_frame_flags
    if frame_type.is_intra:
        if frame_size_override:
            fw, fh = override_dims
            w.put(fw - 1, 16)
            w.put(fh - 1, 16)
        if enable_superres:
            w.put(1 if use_superres else 0, 1)
            if use_superres:
                w.put(coded_denom, 3)
        w.put(1 if render_size_different else 0, 1)
        if render_size_different:
            w.put(render_dims[0] - 1, 16)
            w.put(render_dims[1] - 1, 16)
    else:
        if enable_order_hint:
            w.put(0, 1)  # frame_refs_short_signaling
        for _ in range(7):
            w.put(0, 3)  # ref_frame_idx
            if frame_id_numbers:
                w.put(1, 7)  # delta_frame_id_minus_1
        if frame_type == FrameType.SWITCH:
            # override implied + error_resilient -> explicit frame_size
            # (not frame_size_with_refs), spec 5.9.5
            w.put(cfg.width - 1, 16)
            w.put(cfg.height - 1, 16)
            if enable_superres:
                w.put(1 if use_superres else 0, 1)
                if use_superres:
                    w.put(coded_denom, 3)
        elif frame_size_override:
            raise NotImplementedError("inter size override not built")
        elif enable_superres:
            w.put(0, 1)
        w.put(0, 1)  # render_and_frame_size_different
        w.put(0, 1)  # allow_high_precision_mv
        w.put(1, 1)  # is_filter_switchable
        w.put(0, 1)  # is_motion_mode_switchable
    w.put(1, 1)  # uniform_tile_spacing_flag
    w.put(100, 8)  # base_q_idx
    w.put(0, 1)  # delta_q_y_dc
    w.put(0, 1)  # delta_q_u_dc
    w.put(0, 1)  # delta_q_u_ac
    w.put(0, 1)  # using_qmatrix
    # segmentation
    w.put(1 if segmentation else 0, 1)
    if segmentation:
        # primary_ref_frame == NONE for intra -> update_data implied;
        # for the inter path here primary_ref=0 so write the flags
        if not frame_type.is_intra:
            w.put(1, 1)  # segmentation_update_map
            w.put(0, 1)  # segmentation_temporal_update
            w.put(1, 1)  # segmentation_update_data
        for i in range(8):
            for j in range(8):
                en = i == 0 and j in (0, 5)
                w.put(1 if en else 0, 1)
                if en:
                    if j == 0:  # ALT_Q: signed 1+8
                        w.put_su(-20, 9)
                    else:  # feature 5: unsigned 3 bits
                        w.put(4, 3)
    # delta q params
    w.put(1 if delta_q else 0, 1)  # delta_q_present (base_q_idx > 0)
    if delta_q:
        w.put(2, 2)  # delta_q_res
        w.put(1, 1)  # delta_lf_present
        w.put(1, 2)  # delta_lf_res
        w.put(1, 1)  # delta_lf_multi
    # loop filter
    w.put(3, 6)  # level[0]
    w.put(2, 6)  # level[1]
    w.put(1, 6)  # level[2] (levels nonzero, 3 planes)
    w.put(1, 6)  # level[3]
    w.put(0, 3)  # sharpness
    w.put(1 if lf_deltas else 0, 1)  # loop_filter_delta_enabled
    if lf_deltas:
        w.put(1, 1)  # loop_filter_delta_update
        for i in range(8):
            en = i in (0, 3)
            w.put(1 if en else 0, 1)
            if en:
                w.put_su(-5 + i, 7)
        for i in range(2):
            w.put(1 if i == 0 else 0, 1)
            if i == 0:
                w.put_su(3, 7)
    w.put(0, 1)  # tx_mode_select
    if not frame_type.is_intra:
        w.put(0, 1)  # reference_select
    w.put(0, 1)  # reduced_tx_set
    if not frame_type.is_intra:
        for _ in range(7):
            w.put(0, 1)  # is_global
    if grain is not None:
        write_film_grain_params(w, grain, frame_type, _color_config_of(cfg))
    elif grain_disabled_bit:
        w.put(0, 1)
    w.byte_align(0)
    return build_obu(6, w.getvalue() + tile_payload)


def build_show_existing_frame(idx: int = 0, frame_id_numbers: bool = False) -> bytes:
    """A standalone FrameHeader OBU with show_existing_frame=1."""
    w = BitWriter()
    w.put(1, 1)  # show_existing_frame
    w.put(idx, 3)  # frame_to_show_map_idx
    if frame_id_numbers:
        w.put(321, 10)  # display_frame_id
    w.align_trailing_bits()
    return build_obu(3, w.getvalue())
