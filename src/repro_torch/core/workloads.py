"""The paper's seven evaluation DNNs as layer-shape tables (§6.2).

Conv layers are (k*k*Cin)-row filters with H_out*W_out output positions;
FC/projection layers are d_in-row filters with one position per token.
GoogLeNet / InceptionV3 / ShuffleNetV2 branch structures are lightly
approximated; ResNet / MobileNetV2 / BERT tables are
exact. Ratios RAELLA/ISAAC depend on filter-length and signedness
distributions, which these tables carry faithfully.

A copy of the JAX package's ``repro.core.workloads``, table for table.
"""

from __future__ import annotations

from repro_torch.core.mapping import LayerShape


def _conv(name, cin, cout, k, hw, stride=1, signed=False, depthwise=False,
          last=False) -> LayerShape:
    out_hw = hw // stride
    flen = (k * k) if depthwise else (k * k * cin)
    return LayerShape(name=name, filter_len=flen, n_filters=cout,
                      n_positions=out_hw * out_hw, signed_inputs=signed,
                      depthwise=depthwise, last_layer=last,
                      row_positions=out_hw)


def _fc(name, din, dout, tokens=1, signed=False, last=False) -> LayerShape:
    return LayerShape(name=name, filter_len=din, n_filters=dout,
                      n_positions=tokens, signed_inputs=signed, last_layer=last,
                      row_positions=tokens)


def resnet18() -> list[LayerShape]:
    ls = [_conv("conv1", 3, 64, 7, 224, 2)]
    cfg = [(64, 64, 2, 1, 56), (64, 128, 2, 2, 56), (128, 256, 2, 2, 28),
           (256, 512, 2, 2, 14)]
    for cin, cout, blocks, stride, hw in cfg:
        for b in range(blocks):
            s = stride if b == 0 else 1
            c_in = cin if b == 0 else cout
            ls.append(_conv(f"l{cout}b{b}c1", c_in, cout, 3, hw, s))
            ls.append(_conv(f"l{cout}b{b}c2", cout, cout, 3, hw // stride, 1))
            if b == 0 and (s != 1 or c_in != cout):
                ls.append(_conv(f"l{cout}down", c_in, cout, 1, hw, s))
    ls.append(_fc("fc", 512, 1000, last=True))
    return ls


def resnet50() -> list[LayerShape]:
    ls = [_conv("conv1", 3, 64, 7, 224, 2)]
    cfg = [(64, 256, 3, 1, 56), (256, 512, 4, 2, 56), (512, 1024, 6, 2, 28),
           (1024, 2048, 3, 2, 14)]
    for cin, cout, blocks, stride, hw in cfg:
        mid = cout // 4
        for b in range(blocks):
            s = stride if b == 0 else 1
            c_in = cin if b == 0 else cout
            ohw = hw // stride if b > 0 else hw
            ls.append(_conv(f"l{cout}b{b}c1", c_in, mid, 1, ohw if b else hw, 1))
            ls.append(_conv(f"l{cout}b{b}c2", mid, mid, 3, ohw if b else hw, s))
            ls.append(_conv(f"l{cout}b{b}c3", mid, cout, 1, ohw, 1))
            if b == 0:
                ls.append(_conv(f"l{cout}down", c_in, cout, 1, hw, s))
    ls.append(_fc("fc", 2048, 1000, last=True))
    return ls


def mobilenet_v2() -> list[LayerShape]:
    ls = [_conv("conv1", 3, 32, 3, 224, 2)]
    cin, hw = 32, 112
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, c, n, s in cfg:
        for b in range(n):
            stride = s if b == 0 else 1
            mid = cin * t
            if t != 1:
                ls.append(_conv(f"ir{c}b{b}exp", cin, mid, 1, hw, 1))
            ls.append(_conv(f"ir{c}b{b}dw", mid, mid, 3, hw, stride,
                            depthwise=True))
            hw = hw // stride
            ls.append(_conv(f"ir{c}b{b}proj", mid, c, 1, hw, 1))
            cin = c
    ls.append(_conv("conv_last", 320, 1280, 1, 7, 1))
    ls.append(_fc("fc", 1280, 1000, last=True))
    return ls


def shufflenet_v2() -> list[LayerShape]:
    ls = [_conv("conv1", 3, 24, 3, 224, 2)]
    hw, cin = 56, 24
    for cout, n in [(116, 4), (232, 8), (464, 4)]:
        for b in range(n):
            stride = 2 if b == 0 else 1
            half = cout // 2
            c_in = cin if b == 0 else half
            ls.append(_conv(f"s{cout}b{b}p1", c_in, half, 1, hw, 1))
            ls.append(_conv(f"s{cout}b{b}dw", half, half, 3, hw, stride,
                            depthwise=True))
            if b == 0:
                hw = hw // 2
            ls.append(_conv(f"s{cout}b{b}p2", half, half, 1, hw, 1))
            cin = cout
    ls.append(_conv("conv5", 464, 1024, 1, 7, 1))
    ls.append(_fc("fc", 1024, 1000, last=True))
    return ls


def googlenet() -> list[LayerShape]:
    ls = [_conv("conv1", 3, 64, 7, 224, 2),
          _conv("conv2", 64, 64, 1, 56, 1),
          _conv("conv3", 64, 192, 3, 56, 1)]
    # inception (in, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj, hw)
    inc = [("3a", 192, 64, 96, 128, 16, 32, 32, 28),
           ("3b", 256, 128, 128, 192, 32, 96, 64, 28),
           ("4a", 480, 192, 96, 208, 16, 48, 64, 14),
           ("4b", 512, 160, 112, 224, 24, 64, 64, 14),
           ("4c", 512, 128, 128, 256, 24, 64, 64, 14),
           ("4d", 512, 112, 144, 288, 32, 64, 64, 14),
           ("4e", 528, 256, 160, 320, 32, 128, 128, 14),
           ("5a", 832, 256, 160, 320, 32, 128, 128, 7),
           ("5b", 832, 384, 192, 384, 48, 128, 128, 7)]
    for n, cin, c1, c3r, c3, c5r, c5, pp, hw in inc:
        ls += [_conv(f"i{n}_1x1", cin, c1, 1, hw),
               _conv(f"i{n}_3r", cin, c3r, 1, hw),
               _conv(f"i{n}_3x3", c3r, c3, 3, hw),
               _conv(f"i{n}_5r", cin, c5r, 1, hw),
               _conv(f"i{n}_5x5", c5r, c5, 5, hw),
               _conv(f"i{n}_pp", cin, pp, 1, hw)]
    ls.append(_fc("fc", 1024, 1000, last=True))
    return ls


def inception_v3() -> list[LayerShape]:
    ls = [_conv("c1", 3, 32, 3, 299, 2), _conv("c2", 32, 32, 3, 149, 1),
          _conv("c3", 32, 64, 3, 147, 1), _conv("c4", 64, 80, 1, 73, 1),
          _conv("c5", 80, 192, 3, 71, 2)]
    for i, cin in enumerate([192, 256, 288]):  # 3x inception-A @35
        ls += [_conv(f"a{i}_1", cin, 64, 1, 35), _conv(f"a{i}_5r", cin, 48, 1, 35),
               _conv(f"a{i}_5", 48, 64, 5, 35), _conv(f"a{i}_3r", cin, 64, 1, 35),
               _conv(f"a{i}_3a", 64, 96, 3, 35), _conv(f"a{i}_3b", 96, 96, 3, 35),
               _conv(f"a{i}_pp", cin, 64 if i else 32, 1, 35)]
    ls += [_conv("redA_3", 288, 384, 3, 35, 2), _conv("redA_3r", 288, 64, 1, 35),
           _conv("redA_3a", 64, 96, 3, 35), _conv("redA_3b", 96, 96, 3, 35, 2)]
    for i, c7 in enumerate([128, 160, 160, 192]):  # 4x inception-B @17
        cin = 768
        ls += [_conv(f"b{i}_1", cin, 192, 1, 17), _conv(f"b{i}_7r", cin, c7, 1, 17),
               _conv(f"b{i}_7a", c7, c7, 3, 17), _conv(f"b{i}_7b", c7, 192, 3, 17),
               _conv(f"b{i}_dr", cin, c7, 1, 17), _conv(f"b{i}_da", c7, c7, 3, 17),
               _conv(f"b{i}_db", c7, c7, 3, 17), _conv(f"b{i}_dc", c7, c7, 3, 17),
               _conv(f"b{i}_dd", c7, 192, 3, 17), _conv(f"b{i}_pp", cin, 192, 1, 17)]
    ls += [_conv("redB_3r", 768, 192, 1, 17), _conv("redB_3", 192, 320, 3, 17, 2),
           _conv("redB_7r", 768, 192, 1, 17), _conv("redB_7a", 192, 192, 3, 17),
           _conv("redB_7b", 192, 192, 3, 17, 2)]
    for i, cin in enumerate([1280, 2048]):  # 2x inception-C @8
        ls += [_conv(f"c{i}_1", cin, 320, 1, 8), _conv(f"c{i}_3r", cin, 384, 1, 8),
               _conv(f"c{i}_3a", 384, 384, 3, 8), _conv(f"c{i}_3b", 384, 384, 3, 8),
               _conv(f"c{i}_dr", cin, 448, 1, 8), _conv(f"c{i}_da", 448, 384, 3, 8),
               _conv(f"c{i}_db", 384, 384, 3, 8), _conv(f"c{i}_pp", cin, 192, 1, 8)]
    ls.append(_fc("fc", 2048, 1000, last=True))
    return ls


def bert_large_ffn(seq: int = 384) -> list[LayerShape]:
    """Feedforward layers of BERT-Large (paper accelerates these; GELU ->
    signed inputs -> two-cycle processing)."""
    ls = []
    for i in range(24):
        ls.append(_fc(f"ffn{i}_up", 1024, 4096, tokens=seq, signed=True))
        ls.append(_fc(f"ffn{i}_down", 4096, 1024, tokens=seq, signed=True,
                      last=(i == 23)))
    return ls


WORKLOADS = {
    "resnet18": resnet18,
    "resnet50": resnet50,
    "googlenet": googlenet,
    "inception_v3": inception_v3,
    "mobilenet_v2": mobilenet_v2,
    "shufflenet_v2": shufflenet_v2,
    "bert_large": bert_large_ffn,
}
