from cone_tpu_torch.data.store import (
    FeatureStore,
    InMemoryArrayStore,
    PackedArrayStore,
    TextFeatureStore,
    write_packed_store,
)
from cone_tpu_torch.data.dataset import GroundingDataset, QueryExample, TrainLoader
from cone_tpu_torch.data.synthetic import make_synthetic_dataset
