"""Image classification models — the port of
``paddle_tpu/models/image.py``: ``mnist_mlp``, ``smallnet``,
``alexnet``, ``vgg16``, ``googlenet`` and ``resnet`` / ``resnet50``
(with the space-to-depth stem variant).

Every builder takes an image ``data`` layer named "image" (flat
channel-major ``[b, c*h*w]``, the paddle feed convention) and a
``label`` layer, and returns a ``ModelSpec`` with cost, output and
error nodes. The graphs, layer names and parameter names are the JAX
package's, so a topology serializes identically and a
``paddle_tpu.params.v1`` tar moves between the packages.
"""

from __future__ import annotations

from paddle_tpu_torch import activation as act
from paddle_tpu_torch import layers as layer
from paddle_tpu_torch import networks
from paddle_tpu_torch import pooling
from paddle_tpu_torch.core.data_type import dense_vector, integer_value
from paddle_tpu_torch.models.transformer import ModelSpec


def _image_inputs(height: int, width: int, channels: int, num_classes: int):
    img = layer.data("image", dense_vector(height * width * channels),
                     height=height, width=width)
    lbl = layer.data("label", integer_value(num_classes))
    return img, lbl


def _close(name, img, out, lbl) -> ModelSpec:
    cost = layer.classification_cost(out, lbl, name=f"{name}_cost")
    err = layer.classification_error(out, lbl, name=f"{name}_error")
    return ModelSpec(name=name, data=img, label=lbl, output=out, cost=cost,
                     error=err)


def mnist_mlp(num_classes: int = 10) -> ModelSpec:
    """784 -> 128 -> 64 -> softmax."""
    img = layer.data("image", dense_vector(784))
    lbl = layer.data("label", integer_value(num_classes))
    h1 = layer.fc(img, size=128, act=act.Relu(), name="mlp_h1")
    h2 = layer.fc(h1, size=64, act=act.Relu(), name="mlp_h2")
    out = layer.fc(h2, size=num_classes, act=act.Softmax(), name="mlp_out")
    return _close("mnist_mlp", img, out, lbl)


def smallnet(height: int = 32, width: int = 32, channels: int = 3,
             num_classes: int = 10) -> ModelSpec:
    """The CIFAR-quick net."""
    img, lbl = _image_inputs(height, width, channels, num_classes)
    t = layer.img_conv(img, filter_size=5, num_filters=32,
                       num_channels=channels, stride=1, padding=2,
                       act=act.Relu(), name="sn_conv1")
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1, name="sn_pool1")
    t = layer.img_conv(t, filter_size=5, num_filters=32, stride=1, padding=2,
                       act=act.Relu(), name="sn_conv2")
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1,
                       pool_type=pooling.Avg(), name="sn_pool2")
    t = layer.img_conv(t, filter_size=3, num_filters=64, stride=1, padding=1,
                       act=act.Relu(), name="sn_conv3")
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1,
                       pool_type=pooling.Avg(), name="sn_pool3")
    t = layer.fc(t, size=64, act=act.Relu(), name="sn_fc1")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="sn_out")
    return _close("smallnet", img, out, lbl)


def alexnet(height: int = 227, width: int = 227, channels: int = 3,
            num_classes: int = 1000) -> ModelSpec:
    img, lbl = _image_inputs(height, width, channels, num_classes)
    t = layer.img_conv(img, filter_size=11, num_filters=96,
                       num_channels=channels, stride=4, padding=1,
                       act=act.Relu(), name="an_conv1")
    t = layer.img_cmrnorm(t, size=5, scale=0.0001, power=0.75,
                          name="an_norm1")
    t = layer.img_pool(t, pool_size=3, stride=2, name="an_pool1")
    t = layer.img_conv(t, filter_size=5, num_filters=256, stride=1, padding=2,
                       act=act.Relu(), name="an_conv2")
    t = layer.img_cmrnorm(t, size=5, scale=0.0001, power=0.75,
                          name="an_norm2")
    t = layer.img_pool(t, pool_size=3, stride=2, name="an_pool2")
    t = layer.img_conv(t, filter_size=3, num_filters=384, stride=1, padding=1,
                       act=act.Relu(), name="an_conv3")
    t = layer.img_conv(t, filter_size=3, num_filters=384, stride=1, padding=1,
                       act=act.Relu(), name="an_conv4")
    t = layer.img_conv(t, filter_size=3, num_filters=256, stride=1, padding=1,
                       act=act.Relu(), name="an_conv5")
    t = layer.img_pool(t, pool_size=3, stride=2, name="an_pool5")
    t = layer.fc(t, size=4096, act=act.Relu(), name="an_fc6")
    t = layer.dropout(t, 0.5, name="an_drop6")
    t = layer.fc(t, size=4096, act=act.Relu(), name="an_fc7")
    t = layer.dropout(t, 0.5, name="an_drop7")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="an_out")
    return _close("alexnet", img, out, lbl)


def vgg16(height: int = 224, width: int = 224, channels: int = 3,
          num_classes: int = 1000) -> ModelSpec:
    img, lbl = _image_inputs(height, width, channels, num_classes)
    out = networks.vgg_16_network(img, num_channels=channels,
                                  num_classes=num_classes)
    return _close("vgg16", img, out, lbl)


# ---------------------------------------------------------------------------
# GoogleNet (inception v1)


def _inception(name, input, f1, f3r, f3, f5r, f5, proj):
    # the three 1x1 branches (direct, 3x3 reducer, 5x5 reducer) are one
    # wide 1x1 conv cut into channel slices, as in the JAX package: the
    # same arithmetic, and the block input is read once
    c1x1 = layer.img_conv(input, filter_size=1, num_filters=f1 + f3r + f5r,
                          act=act.Relu(), name=f"{name}_1x1s")
    c1 = layer.slice_projection(c1x1, 0, f1, channel_slice=True)
    c3r = layer.slice_projection(c1x1, f1, f1 + f3r, channel_slice=True)
    c5r = layer.slice_projection(c1x1, f1 + f3r, f1 + f3r + f5r,
                                 channel_slice=True)
    c3 = layer.img_conv(c3r, filter_size=3, num_filters=f3, padding=1,
                        act=act.Relu(), name=f"{name}_3x3")
    c5 = layer.img_conv(c5r, filter_size=5, num_filters=f5, padding=2,
                        act=act.Relu(), name=f"{name}_5x5")
    mp = layer.img_pool(input, pool_size=3, stride=1, padding=1,
                        name=f"{name}_maxpool")
    cp = layer.img_conv(mp, filter_size=1, num_filters=proj, act=act.Relu(),
                        name=f"{name}_proj")
    return layer.concat([c1, c3, c5, cp], name=f"{name}_concat")


def googlenet(height: int = 224, width: int = 224, channels: int = 3,
              num_classes: int = 1000) -> ModelSpec:
    img, lbl = _image_inputs(height, width, channels, num_classes)
    t = layer.img_conv(img, filter_size=7, num_filters=64,
                       num_channels=channels, stride=2, padding=3,
                       act=act.Relu(), name="gn_conv1")
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1, name="gn_pool1")
    t = layer.img_conv(t, filter_size=1, num_filters=64, act=act.Relu(),
                       name="gn_conv2r")
    t = layer.img_conv(t, filter_size=3, num_filters=192, padding=1,
                       act=act.Relu(), name="gn_conv2")
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1, name="gn_pool2")
    t = _inception("gn_i3a", t, 64, 96, 128, 16, 32, 32)
    t = _inception("gn_i3b", t, 128, 128, 192, 32, 96, 64)
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1, name="gn_pool3")
    t = _inception("gn_i4a", t, 192, 96, 208, 16, 48, 64)
    t = _inception("gn_i4b", t, 160, 112, 224, 24, 64, 64)
    t = _inception("gn_i4c", t, 128, 128, 256, 24, 64, 64)
    t = _inception("gn_i4d", t, 112, 144, 288, 32, 64, 64)
    t = _inception("gn_i4e", t, 256, 160, 320, 32, 128, 128)
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1, name="gn_pool4")
    t = _inception("gn_i5a", t, 256, 160, 320, 32, 128, 128)
    t = _inception("gn_i5b", t, 384, 192, 384, 48, 128, 128)
    t = layer.global_img_pool(t, pool_type=pooling.Avg(), name="gn_gap")
    t = layer.dropout(t, 0.4, name="gn_drop")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="gn_out")
    return _close("googlenet", img, out, lbl)


# ---------------------------------------------------------------------------
# ResNet (v1.5: the stride in the bottleneck's 3x3)

_RESNET_BLOCKS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def _conv_bn(name, x, k, nf, stride=1, padding=0, relu=True,
             num_channels=None):
    # the plain two-layer composition, as in the JAX package
    c = layer.img_conv(x, filter_size=k, num_filters=nf, stride=stride,
                       padding=padding, bias_attr=False, act=None,
                       num_channels=num_channels, name=f"{name}_conv")
    return layer.batch_norm(c, act=act.Relu() if relu else None,
                            name=f"{name}_bn")


def _basic_block(name, x, nf, stride):
    t = _conv_bn(f"{name}_a", x, 3, nf, stride=stride, padding=1)
    t = _conv_bn(f"{name}_b", t, 3, nf, padding=1, relu=False)
    if stride != 1 or x.meta.channels != nf:
        x = _conv_bn(f"{name}_sc", x, 1, nf, stride=stride, relu=False)
    return layer.addto([t, x], act=act.Relu(), name=f"{name}_add")


def _bottleneck_block(name, x, nf, stride):
    t = _conv_bn(f"{name}_a", x, 1, nf)
    t = _conv_bn(f"{name}_b", t, 3, nf, stride=stride, padding=1)
    t = _conv_bn(f"{name}_c", t, 1, nf * 4, relu=False)
    if stride != 1 or x.meta.channels != nf * 4:
        x = _conv_bn(f"{name}_sc", x, 1, nf * 4, stride=stride, relu=False)
    return layer.addto([t, x], act=act.Relu(), name=f"{name}_add")


def resnet(depth: int = 50, height: int = 224, width: int = 224,
           channels: int = 3, num_classes: int = 1000,
           tpu_stem: bool = False) -> ModelSpec:
    """ResNet at ``depth``. ``tpu_stem`` opens with space_to_depth(2) and
    a 5x5 conv instead of the 7x7/2 conv: a model variant whose weights
    do not interchange with the default stem's."""
    kind, reps = _RESNET_BLOCKS[depth]
    block = _basic_block if kind == "basic" else _bottleneck_block
    img, lbl = _image_inputs(height, width, channels, num_classes)
    if tpu_stem:
        t = layer.space_to_depth(img, factor=2, num_channels=channels)
        t = _conv_bn("rn_stem", t, 5, 64, stride=1, padding=2)
    else:
        t = _conv_bn("rn_stem", img, 7, 64, stride=2, padding=3,
                     num_channels=channels)
    # floor pooling keeps the canonical 56/28/14/7 feature-map chain
    t = layer.img_pool(t, pool_size=3, stride=2, padding=1,
                       ceil_mode=False, name="rn_pool1")
    nf = 64
    for si, n in enumerate(reps):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            t = block(f"rn_s{si}b{bi}", t, nf, stride)
        nf *= 2
    t = layer.global_img_pool(t, pool_type=pooling.Avg(), name="rn_gap")
    out = layer.fc(t, size=num_classes, act=act.Softmax(), name="rn_out")
    return _close(f"resnet{depth}", img, out, lbl)


def resnet50(**kw) -> ModelSpec:
    return resnet(50, **kw)
