"""The seven representative DNN applications of paper §5.1 as computation
graphs, plus the §5.2 multi-context mix and the §5.3 four-step Faster-R-CNN
sensitivity builds.

Each builder returns a `ComputationGraph` whose vertices carry `Op`s in the
canonical 2-D-convolution coordinates of Table 1.  Dimensions follow the
public architecture definitions (Inception-v3 [23], ResNet-v1-50 [25],
DeepLabv3/MobileNetV2 [24], Faster R-CNN [26], PTB-LSTM [27], Wide&Deep [28],
NASNet-A [29]).  The paper parses frozen TensorFlow graphs; we construct the
same layer streams programmatically — op *kinds* and dimensions match the
published architectures, which is what the cost model consumes.

Non-compute ops (concat, residual add, pooling) appear as data-only nodes so
the dynamic-memory analysis (Fig. 5) sees the true liveness structure, but
they contribute no cycles ("We only focus on the time-consuming
operations", §4.1).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.costmodel import Op, OpKind
from repro_torch.core.graph import ComputationGraph

__all__ = [
    "build_app", "APP_BUILDERS", "APP_NAMES", "zoo_app_names",
    "all_app_names",
    "inception_v3", "deeplab_v3", "resnet_v1_50", "faster_rcnn",
    "ptb_lstm", "wide_and_deep", "nasnet_a",
    "multi_context", "faster_rcnn_step",
]

BITS = 8     # quantized datapath (dynamic-precision quantization, cf. [7])


# --------------------------------------------------------------- helpers

class _B:
    """Tiny graph-builder DSL: tracks the frontier tensor (name, H, W, C)."""

    def __init__(self, name: str, h: int, w: int, c: int):
        self.g = ComputationGraph()
        self.n = 0
        self.prefix = name
        self.head = self.g.add(f"{name}/input", None, h * w * c * BITS)
        self.h, self.w, self.c = h, w, c

    def _name(self, tag: str) -> str:
        self.n += 1
        return f"{self.prefix}/{tag}_{self.n}"

    def _out_hw(self, k: int, s: int, pad: str) -> Tuple[int, int]:
        if pad == "same":
            return -(-self.h // s), -(-self.w // s)
        return (self.h - k) // s + 1, (self.w - k) // s + 1

    def conv(self, cout: int, k: int, s: int = 1, pad: str = "same",
             src: Optional[str] = None,
             shape: Optional[Tuple[int, int, int]] = None) -> str:
        h, w, c = shape if shape else (self.h, self.w, self.c)
        oh, ow = ((-(-h // s), -(-w // s)) if pad == "same"
                  else ((h - k) // s + 1, (w - k) // s + 1))
        kind = OpKind.CHANNEL_MIXING if k == 1 else OpKind.CONV2D
        op = Op(kind, c, h, w, k, k, cout, oh, ow, s, name=self._name(
            f"conv{k}x{k}"))
        node = self.g.add_op(op, [src or self.head], BITS)
        self.head, self.h, self.w, self.c = node, oh, ow, cout
        return node

    def dwconv(self, k: int, s: int = 1, pad: str = "same",
               src: Optional[str] = None,
               shape: Optional[Tuple[int, int, int]] = None) -> str:
        h, w, c = shape if shape else (self.h, self.w, self.c)
        oh, ow = ((-(-h // s), -(-w // s)) if pad == "same"
                  else ((h - k) // s + 1, (w - k) // s + 1))
        op = Op(OpKind.DEPTHWISE_CONV, 1, h, w, k, k, 1, oh, ow, s,
                name=self._name(f"dw{k}x{k}"), repeat=c)
        node = self.g.add_op(op, [src or self.head], BITS)
        self.head, self.h, self.w, self.c = node, oh, ow, c
        return node

    def pool(self, k: int, s: int, pad: str = "valid",
             src: Optional[str] = None) -> str:
        oh, ow = self._out_hw(k, s, pad)
        node = self.g.add(self._name("pool"), None, oh * ow * self.c * BITS,
                          parents=[src or self.head])
        self.head, self.h, self.w = node, oh, ow
        return node

    def global_pool(self, src: Optional[str] = None) -> str:
        node = self.g.add(self._name("gap"), None, self.c * BITS,
                          parents=[src or self.head])
        self.head, self.h, self.w = node, 1, 1
        return node

    def concat(self, srcs: Sequence[str], channels: Sequence[int]) -> str:
        c = sum(channels)
        node = self.g.add(self._name("concat"), None,
                          self.h * self.w * c * BITS, parents=list(srcs))
        self.head, self.c = node, c
        return node

    def add(self, a: str, b: str, c: int) -> str:
        node = self.g.add(self._name("add"), None,
                          self.h * self.w * c * BITS, parents=[a, b])
        self.head, self.c = node, c
        return node

    def fc(self, cout: int, src: Optional[str] = None, batch: int = 1) -> str:
        """Fully-connected == matrix-vector multiply (Table 1 row 4)."""
        cin = self.c * self.h * self.w
        op = Op.matvec(col=cin, row=cout, batch=batch,
                       name=self._name("fc"))
        node = self.g.add(op.name, op, cout * BITS, cin * cout * BITS,
                          [src or self.head])
        self.head, self.h, self.w, self.c = node, 1, 1, cout
        return node

    def matmul(self, rows: int, inner: int, cols: int,
               src: Optional[str] = None, name: str = "") -> str:
        op = Op.matmul(col1=inner, row1=rows, col2=cols,
                       name=name or self._name("matmul"))
        node = self.g.add(op.name, op, rows * cols * BITS,
                          inner * cols * BITS,
                          [src or self.head] if (src or self.head) else [])
        self.head = node
        return node


# ------------------------------------------------------------ Inception-v3

def inception_v3() -> ComputationGraph:
    """Inception-v3 [23], 299x299 input; stem + A/B/C modules + logits."""
    b = _B("inception", 299, 299, 3)
    # stem
    b.conv(32, 3, 2, "valid")
    b.conv(32, 3, 1, "valid")
    b.conv(64, 3, 1, "same")
    b.pool(3, 2)
    b.conv(80, 1)
    b.conv(192, 3, 1, "valid")
    b.pool(3, 2)

    def inception_a(pool_ch: int) -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        b1 = b.conv(64, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(48, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(64, 5, src=b2, shape=(h, w, 48))
        b3 = b.conv(64, 1, src=trunk, shape=(h, w, c))
        b3 = b.conv(96, 3, src=b3, shape=(h, w, 64))
        b3 = b.conv(96, 3, src=b3, shape=(h, w, 96))
        bp = b.g.add(b._name("avgpool"), None, h * w * c * BITS, parents=[trunk])
        bp = b.conv(pool_ch, 1, src=bp, shape=(h, w, c))
        b.h, b.w = h, w
        b.concat([b1, b2, b3, bp], [64, 64, 96, pool_ch])

    def reduction_a() -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        b1 = b.conv(384, 3, 2, "valid", src=trunk, shape=(h, w, c))
        b2 = b.conv(64, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(96, 3, src=b2, shape=(h, w, 64))
        b2 = b.conv(96, 3, 2, "valid", src=b2, shape=(h, w, 96))
        oh, ow = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        bp = b.g.add(b._name("maxpool"), None, oh * ow * c * BITS,
                     parents=[trunk])
        b.h, b.w = oh, ow
        b.concat([b1, b2, bp], [384, 96, c])

    def inception_b(ch7: int) -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        b1 = b.conv(192, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(ch7, 1, src=trunk, shape=(h, w, c))
        for kx, ky, co in ((1, 7, ch7), (7, 1, 192)):
            op = Op(OpKind.CONV2D, b.c, h, w, kx, ky, co, h, w, 1,
                    name=b._name(f"conv{kx}x{ky}"))
            b2 = b.g.add_op(op, [b2], BITS)
            b.c = co
        b3 = b.conv(ch7, 1, src=trunk, shape=(h, w, c))
        cprev = ch7
        for kx, ky, co in ((7, 1, ch7), (1, 7, ch7), (7, 1, ch7), (1, 7, 192)):
            op = Op(OpKind.CONV2D, cprev, h, w, kx, ky, co, h, w, 1,
                    name=b._name(f"conv{kx}x{ky}"))
            b3 = b.g.add_op(op, [b3], BITS)
            cprev = co
        bp = b.g.add(b._name("avgpool"), None, h * w * c * BITS, parents=[trunk])
        bp = b.conv(192, 1, src=bp, shape=(h, w, c))
        b.h, b.w = h, w
        b.concat([b1, b2, b3, bp], [192, 192, 192, 192])

    def reduction_b() -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        b1 = b.conv(192, 1, src=trunk, shape=(h, w, c))
        b1 = b.conv(320, 3, 2, "valid", src=b1, shape=(h, w, 192))
        b2 = b.conv(192, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(192, 7, src=b2, shape=(h, w, 192))   # 1x7+7x1 folded
        b2 = b.conv(192, 3, 2, "valid", src=b2, shape=(h, w, 192))
        oh, ow = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        bp = b.g.add(b._name("maxpool"), None, oh * ow * c * BITS,
                     parents=[trunk])
        b.h, b.w = oh, ow
        b.concat([b1, b2, bp], [320, 192, c])

    def inception_c() -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        b1 = b.conv(320, 1, src=trunk, shape=(h, w, c))
        b2 = b.conv(384, 1, src=trunk, shape=(h, w, c))
        b2a = b.conv(384, 3, src=b2, shape=(h, w, 384))
        b2b = b.conv(384, 3, src=b2, shape=(h, w, 384))
        b3 = b.conv(448, 1, src=trunk, shape=(h, w, c))
        b3 = b.conv(384, 3, src=b3, shape=(h, w, 448))
        b3a = b.conv(384, 3, src=b3, shape=(h, w, 384))
        b3b = b.conv(384, 3, src=b3, shape=(h, w, 384))
        bp = b.g.add(b._name("avgpool"), None, h * w * c * BITS, parents=[trunk])
        bp = b.conv(192, 1, src=bp, shape=(h, w, c))
        b.h, b.w = h, w
        b.concat([b1, b2a, b2b, b3a, b3b, bp],
                 [320, 384, 384, 384, 384, 192])

    for pool_ch in (32, 64, 64):
        inception_a(pool_ch)
    reduction_a()
    for ch7 in (128, 160, 160, 192):
        inception_b(ch7)
    reduction_b()
    inception_c()
    inception_c()
    b.global_pool()
    b.fc(1000)
    return b.g


# ----------------------------------------------------------------- ResNet-50

def resnet_v1_50() -> ComputationGraph:
    """ResNet-v1-50 [25], 224x224 input: 53 conv layers + fc."""
    b = _B("resnet", 224, 224, 3)
    b.conv(64, 7, 2)
    b.pool(3, 2, "same")

    def bottleneck(cin: int, cmid: int, cout: int, stride: int) -> None:
        trunk = b.head
        h, w = b.h, b.w
        if stride != 1 or cin != cout:
            short = b.conv(cout, 1, stride, src=trunk, shape=(h, w, cin))
        else:
            short = trunk
        x = b.conv(cmid, 1, stride, src=trunk, shape=(h, w, cin))
        x = b.conv(cmid, 3, src=x, shape=(b.h, b.w, cmid))
        x = b.conv(cout, 1, src=x, shape=(b.h, b.w, cmid))
        b.add(x, short, cout)

    cin = 64
    for (cmid, cout, n, s0) in ((64, 256, 3, 1), (128, 512, 4, 2),
                                (256, 1024, 6, 2), (512, 2048, 3, 2)):
        for i in range(n):
            bottleneck(cin, cmid, cout, s0 if i == 0 else 1)
            cin = cout
    b.global_pool()
    b.fc(1000)
    return b.g


# ---------------------------------------------------------------- DeepLabv3

def deeplab_v3() -> ComputationGraph:
    """DeepLabv3 [24] with a MobileNetV2 backbone at 513x513, output
    stride 16, ASPP; 17 depthwise-separable blocks (Table 3: 17 dw convs)."""
    b = _B("deeplab", 513, 513, 3)
    b.conv(32, 3, 2)

    def inverted_residual(cin: int, cout: int, stride: int, expand: int) -> None:
        trunk = b.head
        h, w = b.h, b.w
        x = trunk
        cmid = cin * expand
        if expand != 1:
            x = b.conv(cmid, 1, src=trunk, shape=(h, w, cin))
        b.dwconv(3, stride, src=x, shape=(b.h, b.w, cmid))
        x = b.conv(cout, 1, src=b.head, shape=(b.h, b.w, cmid))
        if stride == 1 and cin == cout:
            b.add(x, trunk, cout)

    # MobileNetV2 inverted-residual stack (t, c, n, s); strides after
    # os=16 become dilated (stride 1) as in DeepLabv3.
    cin = 32
    for (t, c, n, s) in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                         (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 1),
                         (6, 320, 1, 1)):
        for i in range(n):
            inverted_residual(cin, c, s if i == 0 else 1, t)
            cin = c

    # ASPP: 1x1 + three 3x3 atrous + image pooling, then projection
    trunk = b.head
    h, w, c = b.h, b.w, b.c
    a1 = b.conv(256, 1, src=trunk, shape=(h, w, c))
    a2 = b.conv(256, 3, src=trunk, shape=(h, w, c))
    a3 = b.conv(256, 3, src=trunk, shape=(h, w, c))
    a4 = b.conv(256, 3, src=trunk, shape=(h, w, c))
    gp = b.g.add(b._name("imgpool"), None, c * BITS, parents=[trunk])
    a5 = b.conv(256, 1, src=gp, shape=(1, 1, c))
    b.h, b.w = h, w
    b.concat([a1, a2, a3, a4, a5], [256] * 5)
    b.conv(256, 1)
    b.conv(21, 1)        # per-pixel classifier
    return b.g


# -------------------------------------------------------------- Faster R-CNN

def faster_rcnn(fm_scale: float = 1.0, n_conv: int = 33, n_dw: int = 13,
                with_dw: bool = True, with_mm: bool = True,
                conv_dims_final: bool = True) -> ComputationGraph:
    """Faster R-CNN [26]: backbone + RPN + box head (4 matmul layers).

    The staged keyword arguments implement the §5.3 sensitivity builds:
    step 1  larger feature maps, no dw/mm          (fm_scale>1, False, False)
    step 2  final conv dimensions                  (fm_scale=1)
    step 3  + depthwise separable layers           (with_dw=True)
    step 4  + large matrix-multiplication layers   (with_mm=True)
    """
    base = 800 if conv_dims_final else 600
    side = int(base * fm_scale)
    b = _B("fasterRCNN", side, side, 3)
    b.conv(64, 7, 2)
    b.pool(3, 2, "same")

    # backbone: n_conv 3x3 convs in 4 stages with channel doubling
    stage_ch = (64, 128, 256, 512)
    per_stage = max(1, (n_conv - 2) // 4)
    made = 1
    dw_made = 0
    for si, ch in enumerate(stage_ch):
        if si > 0:
            b.conv(ch, 3, 2)
            made += 1
        for _ in range(per_stage):
            if made >= n_conv - 1:
                break
            b.conv(ch, 3, 1)
            made += 1
            if with_dw and dw_made < n_dw and made % 2 == 0:
                b.dwconv(3, 1)
                b.conv(ch, 1)
                dw_made += 1

    # RPN head: 3x3 conv + two 1x1 siblings
    trunk = b.head
    h, w, c = b.h, b.w, b.c
    rpn = b.conv(512, 3, src=trunk, shape=(h, w, c))
    b.conv(2 * 9, 1, src=rpn, shape=(b.h, b.w, 512))
    cls = b.head
    b.conv(4 * 9, 1, src=rpn, shape=(h, w, 512))
    reg = b.head

    if with_mm:
        # box head over 300 RoIs: flatten 7x7xC -> fc4096 -> fc4096 ->
        # {cls 81, box 324}: 4 matrix-matrix multiplications (Table 3) —
        # the original VGG16 head ("large matrix multiplication layers",
        # §5.3 step 4; ~36 GMACs, comparable to the conv backbone).
        roi = b.g.add(b._name("roialign"), None, 300 * 7 * 7 * c * BITS,
                      parents=[cls, reg])
        m1 = b.matmul(300, 7 * 7 * c, 4096, src=roi, name="fasterRCNN/fc6")
        m2 = b.matmul(300, 4096, 4096, src=m1, name="fasterRCNN/fc7")
        b.matmul(300, 4096, 81, src=m2, name="fasterRCNN/cls_score")
        b.matmul(300, 4096, 324, src=m2, name="fasterRCNN/bbox_pred")
    return b.g


def faster_rcnn_step(step: int) -> ComputationGraph:
    """§5.3 four-step build of Faster R-CNN (Fig. 11)."""
    if step == 1:
        return faster_rcnn(fm_scale=1.5, with_dw=False, with_mm=False)
    if step == 2:
        return faster_rcnn(fm_scale=1.0, with_dw=False, with_mm=False)
    if step == 3:
        return faster_rcnn(fm_scale=1.0, with_dw=True, with_mm=False)
    if step == 4:
        return faster_rcnn()
    raise ValueError(step)


# --------------------------------------------------------------------- PTB

def ptb_lstm(hidden: int = 650, steps: int = 20, layers: int = 2,
             vocab: int = 10000, batch: int = 20) -> ComputationGraph:
    """PTB word-level LSTM [27]: `layers` LSTM layers unrolled `steps`
    times + softmax projection = layers*steps + 1 matmul layers (41 for the
    default, matching Table 3)."""
    g = ComputationGraph()
    prev_layer_out: List[str] = []
    emb = g.add("ptb/embed", None, batch * hidden * BITS)
    h_prev: Dict[int, str] = {}
    for t in range(steps):
        below = emb if t == 0 else prev_layer_out[t - 1]
        x = below
        for l in range(layers):
            parents = [x]
            if l in h_prev:
                parents.append(h_prev[l])
            # fused gate matmul: [batch, 2*hidden] @ [2*hidden, 4*hidden]
            op = Op.matmul(col1=2 * hidden, row1=batch, col2=4 * hidden,
                           name=f"ptb/l{l}_t{t}")
            node = g.add(op.name, op, batch * hidden * BITS,
                         2 * hidden * 4 * hidden * BITS, parents)
            h_prev[l] = node
            x = node
        prev_layer_out.append(x)
    op = Op.matmul(col1=hidden, row1=batch * steps, col2=vocab,
                   name="ptb/softmax")
    g.add(op.name, op, batch * steps * vocab * BITS,
          hidden * vocab * BITS, [prev_layer_out[-1]])
    return g


# ---------------------------------------------------------------- Wide&Deep

def wide_and_deep(batch: int = 128) -> ComputationGraph:
    """Wide & Deep Learning [28]: wide linear part + 3-layer deep MLP
    (3 matrix-matrix multiplication layers, Table 3)."""
    g = ComputationGraph()
    feats = g.add("wdl/features", None, batch * 728 * BITS)
    op1 = Op.matmul(col1=728, row1=batch, col2=64, name="wdl/deep_fc1")
    n1 = g.add(op1.name, op1, batch * 64 * BITS, 728 * 64 * BITS, [feats])
    op2 = Op.matmul(col1=64, row1=batch, col2=32, name="wdl/deep_fc2")
    n2 = g.add(op2.name, op2, batch * 32 * BITS, 64 * 32 * BITS, [n1])
    op3 = Op.matmul(col1=32, row1=batch, col2=16, name="wdl/deep_fc3")
    n3 = g.add(op3.name, op3, batch * 16 * BITS, 32 * 16 * BITS, [n2])
    # wide part: sparse cross-product features -> logistic unit (matvec)
    opw = Op.matvec(col=728, row=1, batch=batch, name="wdl/wide")
    nw = g.add(opw.name, opw, batch * BITS, 728 * BITS, [feats])
    g.add("wdl/logits", None, batch * BITS, parents=[n3, nw])
    return g


# ------------------------------------------------------------------ NASNet

def nasnet_a(cells_per_stack: int = 4, penult_filters: int = 1056) -> \
        ComputationGraph:
    """NASNet-A [29] (mobile, 224x224): stacked normal/reduction cells of
    separable convolutions (= depthwise + pointwise pairs)."""
    b = _B("nasnet", 224, 224, 3)
    b.conv(32, 3, 2)
    filters = penult_filters // 24      # 44 for 1056

    def sep(k: int, cout: int, stride: int, src: str,
            shape: Tuple[int, int, int]) -> str:
        """Separable conv applied twice (NASNet convention)."""
        h, w, c = shape
        b.dwconv(k, stride, src=src, shape=(h, w, c))
        x = b.conv(cout, 1, src=b.head, shape=(b.h, b.w, c))
        b.dwconv(k, 1, src=x, shape=(b.h, b.w, cout))
        return b.conv(cout, 1, src=b.head, shape=(b.h, b.w, cout))

    def cell(cout: int, stride: int) -> None:
        trunk = b.head
        h, w, c = b.h, b.w, b.c
        adj = b.conv(cout, 1, src=trunk, shape=(h, w, c))
        hh, ww = b.h, b.w
        outs = []
        # five branch pairs per NASNet-A cell
        for (k1, k2) in ((3, 5), (5, 3), (3, 3), (5, 5), (3, 3)):
            x1 = sep(k1, cout, stride, adj, (hh, ww, cout))
            x2 = sep(k2, cout, stride, adj, (hh, ww, cout))
            outs.append(b.add(x1, x2, cout))
        b.concat(outs[:4], [cout] * 4)      # 4 of 5 concatenated

    stacks = ((filters, 1), (filters * 2, 2), (filters * 4, 2))
    for (f, s) in stacks:
        cell(f, s)                          # reduction (or first) cell
        for _ in range(cells_per_stack - 1):
            cell(f, 1)
    b.global_pool()
    b.fc(1000)
    return b.g


# ----------------------------------------------------------- InternalsMixer

def multi_context(apps: Sequence[ComputationGraph] = ()) -> ComputationGraph:
    """§5.2: interleave layers of diverse DNNs (default Inception-v3 + PTB)
    into one multi-context stream running on a single accelerator."""
    if not apps:
        apps = (inception_v3(), ptb_lstm())
    g = ComputationGraph()
    streams = [[a.nodes[n] for n in a.operation_stream()] for a in apps]
    idx = [0] * len(streams)
    total = sum(len(s) for s in streams)
    last_of: List[Optional[str]] = [None] * len(streams)
    step = 0
    while sum(idx) < total:
        for si, s in enumerate(streams):
            if idx[si] >= len(s):
                continue
            node = s[idx[si]]
            idx[si] += 1
            parents = [f"mix{si}/{p}" for p in node.parents]
            g.add(f"mix{si}/{node.name}", node.op, node.output_bits,
                  node.weight_bits, parents)
            last_of[si] = f"mix{si}/{node.name}"
            step += 1
    return g


# ----------------------------------------------------------------- registry

APP_BUILDERS = {
    "inception": inception_v3,
    "deeplab": deeplab_v3,
    "resnet": resnet_v1_50,
    "fasterRCNN": faster_rcnn,
    "ptb": ptb_lstm,
    "wdl": wide_and_deep,
    "nasnet": nasnet_a,
}
APP_NAMES = tuple(APP_BUILDERS.keys())


def zoo_app_names() -> Tuple[str, ...]:
    """Traced model-zoo workloads (`<arch>:prefill` / `<arch>:decode`, see
    `repro_torch.frontend.zoo`), all twenty; the archs whose models are
    not ported yet raise when built."""
    from repro_torch.frontend.zoo import ZOO_APP_NAMES
    return ZOO_APP_NAMES


def all_app_names() -> Tuple[str, ...]:
    """The seven paper CNN apps plus every zoo workload."""
    return APP_NAMES + zoo_app_names()


def build_app(name: str) -> ComputationGraph:
    """Resolve any app name: the seven hand-built §5.1 graphs by bare
    name, traced model-zoo workloads by `<arch>:<variant>`."""
    builder = APP_BUILDERS.get(name)
    if builder is not None:
        return builder()
    if ":" in name:
        from repro_torch.frontend.zoo import build_zoo_app
        return build_zoo_app(name)
    raise KeyError(
        f"unknown app {name!r}; hand-built apps: {sorted(APP_BUILDERS)}, "
        f"zoo apps look like 'qwen2-0.5b:prefill' (see "
        f"repro_torch.frontend.zoo)")
