"""Synthetic data and the device input pipeline."""
from repro_torch.data import pipeline, synthetic
from repro_torch.data.pipeline import accuracy, shard_batches, take, to_device
from repro_torch.data.synthetic import (TaskBatch, classification_task,
                                        lm_stream, patch_task,
                                        retrieval_qa_task)
