"""Operations and bytes that a kernel call or a serving step needs,
computed from shapes alone (frozen with the benchmark).

Each function returns ``(flops, bytes)``: the arithmetic the inputs need
(a multiply-add is two operations; rows a kernel pads or computes for
nothing are not counted) and each input byte read once and each output
byte written once, whatever the kernel reads again.
"""
