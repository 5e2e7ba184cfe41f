"""Layer-shape workloads for the cycle-accurate simulator
(a numpy copy of ``repro/core/workloads.py``, the router's cost model).

The paper's study cases (§4.1): ResNet-18 fwd, ResNet-50 fwd, InceptionV3
fwd, ResNet-18 bwd — convolution layers only (the tiles are convolution
tiles). Shapes are the standard ImageNet-224 configurations from public
model definitions. We also expose LM matmul shapes (from our assigned
architectures) mapped to 1x1 convolutions, so the simulator can score the
paper's technique on transformer workloads (beyond-paper extension).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolution workload: OFM = conv(IFM, W).

    Attributes mirror the paper's Fig. 11 loop nest. ``count`` collapses
    repeated identical layers. A fully-connected / matmul layer is the
    special case R = S = Ho = Wo = 1 with batch folded into count or Ho.
    """

    name: str
    c: int       # input channels
    k: int       # output channels
    ho: int      # output height
    wo: int      # output width
    r: int = 3   # filter height
    s: int = 3   # filter width
    count: int = 1

    @property
    def macs(self) -> int:
        return self.c * self.k * self.ho * self.wo * self.r * self.s * self.count

    @property
    def ip_length(self) -> int:
        """Inner-product length per output pixel."""
        return self.c * self.r * self.s


def _bb(name: str, c: int, k: int, hw: int, count: int = 1,
        stride_first: bool = False) -> List[ConvLayer]:
    """ResNet basic block: two 3x3 convs (+ 1x1 shortcut when widening)."""
    layers = [
        ConvLayer(f"{name}.conv1", c, k, hw, hw, 3, 3, count),
        ConvLayer(f"{name}.conv2", k, k, hw, hw, 3, 3, count),
    ]
    if stride_first:
        layers.append(ConvLayer(f"{name}.down", c, k, hw, hw, 1, 1, 1))
    return layers


def resnet18() -> List[ConvLayer]:
    ls: List[ConvLayer] = [ConvLayer("conv1", 3, 64, 112, 112, 7, 7)]
    ls += _bb("layer1.0", 64, 64, 56) + _bb("layer1.1", 64, 64, 56)
    ls += _bb("layer2.0", 64, 128, 28, stride_first=True) + _bb("layer2.1", 128, 128, 28)
    ls += _bb("layer3.0", 128, 256, 14, stride_first=True) + _bb("layer3.1", 256, 256, 14)
    ls += _bb("layer4.0", 256, 512, 7, stride_first=True) + _bb("layer4.1", 512, 512, 7)
    ls.append(ConvLayer("fc", 512, 1000, 1, 1, 1, 1))
    return ls


def _bottleneck(name: str, c_in: int, c_mid: int, hw: int, count: int,
                downsample: bool) -> List[ConvLayer]:
    c_out = 4 * c_mid
    ls = [
        ConvLayer(f"{name}.conv1", c_in, c_mid, hw, hw, 1, 1, count),
        ConvLayer(f"{name}.conv2", c_mid, c_mid, hw, hw, 3, 3, count),
        ConvLayer(f"{name}.conv3", c_mid, c_out, hw, hw, 1, 1, count),
    ]
    if downsample:
        ls.append(ConvLayer(f"{name}.down", c_in, c_out, hw, hw, 1, 1, 1))
    return ls


def resnet50() -> List[ConvLayer]:
    ls: List[ConvLayer] = [ConvLayer("conv1", 3, 64, 112, 112, 7, 7)]
    # (stage, blocks, c_mid, hw)
    ls += _bottleneck("layer1.0", 64, 64, 56, 1, True)
    ls += _bottleneck("layer1.x", 256, 64, 56, 2, False)
    ls += _bottleneck("layer2.0", 256, 128, 28, 1, True)
    ls += _bottleneck("layer2.x", 512, 128, 28, 3, False)
    ls += _bottleneck("layer3.0", 512, 256, 14, 1, True)
    ls += _bottleneck("layer3.x", 1024, 256, 14, 5, False)
    ls += _bottleneck("layer4.0", 1024, 512, 7, 1, True)
    ls += _bottleneck("layer4.x", 2048, 512, 7, 2, False)
    ls.append(ConvLayer("fc", 2048, 1000, 1, 1, 1, 1))
    return ls


def inception_v3() -> List[ConvLayer]:
    """torchvision InceptionV3 conv shapes (aux head omitted)."""
    L = ConvLayer
    ls = [
        L("stem.1", 3, 32, 149, 149, 3, 3), L("stem.2", 32, 32, 147, 147, 3, 3),
        L("stem.3", 32, 64, 147, 147, 3, 3), L("stem.4", 64, 80, 73, 73, 1, 1),
        L("stem.5", 80, 192, 71, 71, 3, 3),
    ]

    def inception_a(name, cin, pool):
        return [
            L(f"{name}.b1", cin, 64, 35, 35, 1, 1),
            L(f"{name}.b5a", cin, 48, 35, 35, 1, 1),
            L(f"{name}.b5b", 48, 64, 35, 35, 5, 5),
            L(f"{name}.b3a", cin, 64, 35, 35, 1, 1),
            L(f"{name}.b3b", 64, 96, 35, 35, 3, 3),
            L(f"{name}.b3c", 96, 96, 35, 35, 3, 3),
            L(f"{name}.pool", cin, pool, 35, 35, 1, 1),
        ]

    ls += inception_a("5b", 192, 32) + inception_a("5c", 256, 64) \
        + inception_a("5d", 288, 64)
    ls += [  # reduction A
        L("6a.b3", 288, 384, 17, 17, 3, 3),
        L("6a.b3d1", 288, 64, 35, 35, 1, 1), L("6a.b3d2", 64, 96, 35, 35, 3, 3),
        L("6a.b3d3", 96, 96, 17, 17, 3, 3),
    ]

    def inception_b(name, c7):
        return [
            L(f"{name}.b1", 768, 192, 17, 17, 1, 1),
            L(f"{name}.b7a", 768, c7, 17, 17, 1, 1),
            L(f"{name}.b7b", c7, c7, 17, 17, 1, 7),
            L(f"{name}.b7c", c7, 192, 17, 17, 7, 1),
            L(f"{name}.d7a", 768, c7, 17, 17, 1, 1),
            L(f"{name}.d7b", c7, c7, 17, 17, 7, 1),
            L(f"{name}.d7c", c7, c7, 17, 17, 1, 7),
            L(f"{name}.d7d", c7, c7, 17, 17, 7, 1),
            L(f"{name}.d7e", c7, 192, 17, 17, 1, 7),
            L(f"{name}.pool", 768, 192, 17, 17, 1, 1),
        ]

    ls += inception_b("6b", 128) + inception_b("6c", 160) \
        + inception_b("6d", 160) + inception_b("6e", 192)
    ls += [  # reduction B
        L("7a.b3a", 768, 192, 17, 17, 1, 1), L("7a.b3b", 192, 320, 8, 8, 3, 3),
        L("7a.b7a", 768, 192, 17, 17, 1, 1), L("7a.b7b", 192, 192, 17, 17, 1, 7),
        L("7a.b7c", 192, 192, 17, 17, 7, 1), L("7a.b7d", 192, 192, 8, 8, 3, 3),
    ]

    def inception_e(name, cin):
        return [
            L(f"{name}.b1", cin, 320, 8, 8, 1, 1),
            L(f"{name}.b3a", cin, 384, 8, 8, 1, 1),
            L(f"{name}.b3b1", 384, 384, 8, 8, 1, 3),
            L(f"{name}.b3b2", 384, 384, 8, 8, 3, 1),
            L(f"{name}.d3a", cin, 448, 8, 8, 1, 1),
            L(f"{name}.d3b", 448, 384, 8, 8, 3, 3),
            L(f"{name}.d3c1", 384, 384, 8, 8, 1, 3),
            L(f"{name}.d3c2", 384, 384, 8, 8, 3, 1),
            L(f"{name}.pool", cin, 192, 8, 8, 1, 1),
        ]

    ls += inception_e("7b", 1280) + inception_e("7c", 2048)
    ls.append(L("fc", 2048, 1000, 1, 1, 1, 1))
    return ls


def resnet18_backward() -> List[ConvLayer]:
    """Backward pass of ResNet-18 as conv workloads: for each fwd conv,
    dX (K->C, transposed filters) and dW (gradient) have the same MAC
    volume as the forward layer; we model them as two conv workloads with
    the fwd shape (standard practice for cycle modelling)."""
    out = []
    for l in resnet18():
        if l.name == "conv1":
            out.append(dataclasses.replace(l, name=l.name + ".dW"))
            continue
        out.append(dataclasses.replace(l, name=l.name + ".dX",
                                       c=l.k, k=l.c))
        out.append(dataclasses.replace(l, name=l.name + ".dW"))
    return out


def lm_projection_layers(d_model: int, d_ff: int, n_layers: int,
                         vocab: int, seq: int = 1, name: str = "lm"
                         ) -> List[ConvLayer]:
    """Transformer projections as 1x1 convs: per-token matmuls with
    C=d_model, K=out features, Ho=seq tokens (beyond-paper workload)."""
    L = ConvLayer
    return [
        L(f"{name}.qkvo", d_model, 4 * d_model, seq, 1, 1, 1, n_layers),
        L(f"{name}.ffn_in", d_model, 2 * d_ff, seq, 1, 1, 1, n_layers),
        L(f"{name}.ffn_out", d_ff, d_model, seq, 1, 1, 1, n_layers),
        L(f"{name}.head", d_model, vocab, seq, 1, 1, 1, 1),
    ]


WORKLOADS = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "inception_v3": inception_v3,
    "resnet18_bwd": resnet18_backward,
}


def total_macs(layers: Iterable[ConvLayer]) -> int:
    return sum(l.macs for l in layers)
