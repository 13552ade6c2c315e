"""Host-side optimizer ops and async file I/O (ZeRO-Offload and
ZeRO-Infinity): the counterpart of ``deepspeed_tpu/ops/cpu/``, over the
repo's host C++ built by ``ops.op_builder.OpBuilder``."""
