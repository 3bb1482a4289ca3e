from keypointfusion_torch.mano.assets import ManoModel, load_mano_model
from keypointfusion_torch.mano.manolayer import (
    ManoLayer, batch_rodrigues, mano_forward,
)
