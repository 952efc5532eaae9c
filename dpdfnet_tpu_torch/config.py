"""Model configurations (own copy of ``dpdfnet_tpu.config``).

One frozen dataclass of hyperparameters per DPDFNet variant; model code is
a function of ``(params, cfg, inputs, state)``.  The six shipped
configurations mirror the reference model zoo.  A test holds every field
and derived property against the JAX package's copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static hyperparameters of one DPDFNet variant."""

    name: str
    sample_rate: int
    n_fft: int                      # == window length (20 ms)
    hop: int                        # 10 ms
    dprnn_blocks: int               # 0 = "baseline" (DeepFilterNet2-like)
    hr: bool = False                # 48 kHz high-resolution variant

    nb_erb: int = 32
    nb_df: int = 96
    conv_ch: int = 64
    gru_dim: int = 256              # enc / erb_dec / df_dec GRU hidden size
    emb_dim: int = 512
    enc_lin_groups: int = 32
    lin_groups: int = 16
    df_order: int = 5
    df_kt: int = 5                  # df pathway conv kernel (time)
    lookahead: int = 2              # frames of algorithmic lookahead
    conv_kernel_inp: Tuple[int, int] = (3, 3)
    conv_kernel: Tuple[int, int] = (1, 3)
    alpha: float = 0.98             # EMA-norm smoothing
    lsnr_min: float = -15.0
    lsnr_max: float = 35.0
    min_nb_freqs: int = 1           # min rfft bins per ERB band
    upsample: str = "subpixel"      # decoder upsampling: subpixel | transpose
    mask_method: str = "before_df"  # before_df | separate | after_df
    emb_gru_skip: str = "none"      # none | identity | groupedlinear
    # >1 selects grouped GRU layers (4 groups, the reference quirk).
    group_gru: int = 1
    # Valin post-filter on the ERB gain mask (16 kHz configs only).
    post_filter: bool = False

    def __post_init__(self) -> None:
        if self.post_filter and self.hr:
            raise ValueError(
                "post_filter applies to the ERB gain mask; 48 kHz HR "
                "configs use a per-bin magnitude mask with no post-filter "
                "analogue in the reference.")

    @property
    def win_len(self) -> int:
        return self.n_fft

    @property
    def freq_bins(self) -> int:
        return self.n_fft // 2 + 1

    @property
    def frame_ms(self) -> float:
        return 1000.0 * self.win_len / self.sample_rate

    @property
    def wnorm(self) -> float:
        from .ops.windows import get_wnorm

        return get_wnorm(self.win_len, self.hop)

    @property
    def erb_in_bins(self) -> int:
        """Frequency bins entering the erb/magnitude encoder branch."""
        if self.hr:
            return self.n_fft // 2        # full-band magnitude, last bin dropped
        return self.nb_erb

    @property
    def erb_fstrides(self) -> Tuple[int, int, int]:
        return (3, 2, 2) if self.hr else (2, 2, 1)

    @property
    def erb_widths(self) -> Tuple[int, int, int, int]:
        """Frequency widths (e0, e1, e2, e3) through the erb encoder."""
        f = self.erb_in_bins
        s1, s2, s3 = self.erb_fstrides
        f1 = -(-f // s1)
        f2 = -(-f1 // s2)
        f3 = -(-f2 // s3)
        return (f, f1, f2, f3)

    @property
    def dprnn_erb_feat(self) -> int:
        return self.erb_widths[3]

    @property
    def dprnn_df_feat(self) -> int:
        return self.nb_df // 2

    @property
    def emb_out_dim(self) -> int:
        return self.conv_ch * self.nb_erb // 4

    @property
    def enc_emb_in_dim(self) -> int:
        return self.emb_dim if self.hr else self.conv_ch * self.nb_erb // 4

    @property
    def dec_f8(self) -> int:
        return self.erb_widths[3]

    @property
    def dec_fstrides(self) -> Tuple[int, int, int]:
        """Frequency upsample factors of convt3/convt2/convt1 (1 = plain conv)."""
        return (2, 2, 3) if self.hr else (1, 2, 2)

    @property
    def mask_bins(self) -> int:
        return self.erb_in_bins if self.hr else self.nb_erb


def _cfg16(name: str, blocks: int) -> ModelConfig:
    return ModelConfig(
        name=name, sample_rate=16_000, n_fft=320, hop=160,
        dprnn_blocks=blocks, hr=False, min_nb_freqs=1,
    )


def _cfg48(name: str, blocks: int) -> ModelConfig:
    return ModelConfig(
        name=name, sample_rate=48_000, n_fft=960, hop=480,
        dprnn_blocks=blocks, hr=True, min_nb_freqs=2, emb_dim=512,
    )


MODEL_CONFIGS: Dict[str, ModelConfig] = {
    "baseline": _cfg16("baseline", 0),
    "dpdfnet2": _cfg16("dpdfnet2", 2),
    "dpdfnet4": _cfg16("dpdfnet4", 4),
    "dpdfnet8": _cfg16("dpdfnet8", 8),
    "dpdfnet2_48khz_hr": _cfg48("dpdfnet2_48khz_hr", 2),
    "dpdfnet8_48khz_hr": _cfg48("dpdfnet8_48khz_hr", 8),
}

DEFAULT_MODEL = "dpdfnet2"


def get_config(name: str) -> ModelConfig:
    try:
        return MODEL_CONFIGS[name]
    except KeyError as exc:
        supported = ", ".join(sorted(MODEL_CONFIGS))
        raise ValueError(f"Unsupported model '{name}'. Supported: {supported}") from exc
