"""Online serving: dynamic batching and an HTTP server over the fast forward
(port of crosstalk_tpu/serve/).

Requests of any size are coalesced into a fixed set of batch shapes, padded
with zero tiles, so the device sees only shapes that were warmed up at
startup and stays busy under concurrent small requests.
"""

from crosstalk_tpu_torch.serve.batcher import DynamicBatcher
from crosstalk_tpu_torch.serve.predictor import make_predictor
from crosstalk_tpu_torch.serve.server import CrosstalkServer

__all__ = ["DynamicBatcher", "make_predictor", "CrosstalkServer"]
