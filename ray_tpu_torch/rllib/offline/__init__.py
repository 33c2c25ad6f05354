"""ray_tpu_torch.rllib.offline: offline-RL data input/output.

The counterpart of ``ray_tpu/rllib/offline``; reference: `rllib/offline/` —
`InputReader` (`input_reader.py`) and the JSON readers/writers
(`json_reader.py`, `json_writer.py`). Batches are dicts of numpy columns over
transitions; JSON files hold one episode (or fragment) per line, in the JAX
package's format; the Ray-Data-backed `DatasetReader` (`dataset_reader.py`)
serves them from a `ray_tpu_torch.data.Dataset`.
"""

from ray_tpu_torch.rllib.offline.input_reader import InputReader
from ray_tpu_torch.rllib.offline.json_reader import JsonReader
from ray_tpu_torch.rllib.offline.json_writer import JsonWriter
from ray_tpu_torch.rllib.offline.dataset_reader import DatasetReader

__all__ = ["DatasetReader", "InputReader", "JsonReader", "JsonWriter"]
