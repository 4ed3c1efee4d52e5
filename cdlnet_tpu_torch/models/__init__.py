from cdlnet_tpu_torch.models.base import MODEL_REGISTRY, build_model
from cdlnet_tpu_torch.models.cdlnet import CDLNet
from cdlnet_tpu_torch.models.cdlnet_video import CDLNetVideo
from cdlnet_tpu_torch.models.csr import CDLNetCSR, CDLNetCSRf2
from cdlnet_tpu_torch.models.dncnn import DnCNN, FFDNet
from cdlnet_tpu_torch.models.gdlnet import GDLNet
