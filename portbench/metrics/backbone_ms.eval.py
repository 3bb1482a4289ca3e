"""Device ms a batch launched under the two backbones' forward
(models/unet.py, resnet.py, convnext.py, layers.py): the harness's
`pb.backbone` range, opened by forward hooks on backbone_d and
backbone_rgb."""


def read(view):
    return view.per_unit_ms(lambda o: o.under('pb.backbone'))
