"""Operations and bytes of each kernel family, worked out from the shapes of
a call: the yardstick of the roofline shares.  One file per family."""
