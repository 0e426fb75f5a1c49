"""Ops: input scaling and the device multi-crop, the landmark patch
gather, the fused MLPs, the LN-fused projection, fused and flash
attention, mixup, patchify and the SSL schedules."""
