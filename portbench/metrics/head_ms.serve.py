"""Device ms a batch launched in the model's forward outside the two
backbones: the fusion head (models/kpfusion.py, fusion_block.py,
desa.py, transformer.py, ops/, geometry/, the kernels K1 and K2)."""


def read(view):
    return view.per_unit_ms(lambda o: o.under('pb.model')
                            and not o.under('pb.backbone'))
