from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import lm_batch_stream
from repro_torch.data.text import ByteCorpus, repo_corpus

__all__ = ["ByteCorpus", "DataPipeline", "lm_batch_stream", "repo_corpus"]
