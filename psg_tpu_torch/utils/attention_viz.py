"""Attention visualisation (port of ``psg_tpu/utils/attention_viz.py``).

Renders per-head cross-attention maps (pixels -> text tokens) as a PNG
grid, from attention probabilities computed here from q and k: the kernels
never form the maps.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def attention_probs(q, k, *, scale=None) -> np.ndarray:
    """[B,H,Lq,D] x [B,H,Lk,D] -> softmax probabilities [B,H,Lq,Lk] (fp32,
    as a numpy array)."""
    q, k = torch.as_tensor(q).float(), torch.as_tensor(k).float()
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.softmax(s, dim=-1).cpu().numpy()


def plot_attention_maps(probs, spatial: int, out_path,
                        tokens: Optional[Sequence[str]] = None,
                        token_indices: Optional[Sequence[int]] = None,
                        sample: int = 0) -> None:
    """probs: [B,H,Lq,Lk] with Lq == spatial * spatial.  Writes a grid: a
    row per selected text token, a column per head, each cell the spatial
    map of the attention paid to that token."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = np.asarray(probs)[sample]
    h, lq, lk = p.shape
    if lq != spatial * spatial:
        raise ValueError(f"{lq} queries is not a {spatial}x{spatial} map")
    token_indices = list(token_indices if token_indices is not None else range(min(4, lk)))

    fig, axes = plt.subplots(len(token_indices), h, figsize=(2 * h, 2 * len(token_indices)),
                             squeeze=False)
    for r, ti in enumerate(token_indices):
        for c in range(h):
            axes[r][c].imshow(p[c, :, ti].reshape(spatial, spatial), cmap="viridis")
            axes[r][c].axis("off")
            if r == 0:
                axes[r][c].set_title(f"head {c}", fontsize=8)
        label = tokens[ti] if tokens and ti < len(tokens) else f"tok {ti}"
        axes[r][0].set_ylabel(label, fontsize=8)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
