"""Training: step builders (pretrain / 4-stage distill) and the
fault-tolerant loop."""
from repro_torch.train import loop, steps
from repro_torch.train.loop import LoopConfig, LoopResult, run
from repro_torch.train.steps import (ATTN_DTYPES, StepConfig, build_distill_step,
                                     build_pretrain_step,
                                     estimate_and_set_sigmas,
                                     init_distill_state, init_pretrain_state,
                                     load_state_tree, state_tree)
