"""Operations and bytes of the live work, per model family, and the peaks."""
