"""Error taxonomy.

Mirrors the reference's two error sets:
  * block codec errors  (reference: src/lz4.zig:48-55)
  * frame format errors (reference: src/lz4f.zig:31-59, 24 variants
    mirroring the LZ4F C error enum)

Python surfaces these as an exception hierarchy so callers can catch
coarsely (``LZ4Error``) or precisely (``ContentChecksumInvalid``).
"""


class LZ4Error(Exception):
    """Base class for every error raised by this framework."""


# --- Block codec errors (reference: src/lz4.zig:48-55) ---

class BlockError(LZ4Error):
    """Base class for block-codec errors."""


class OutputTooSmall(BlockError):
    pass


class InputTooLarge(BlockError):
    pass


class CorruptedData(BlockError):
    pass


class DecompressionFailed(BlockError):
    pass


class InvalidState(BlockError):
    pass


class AllocationFailed(BlockError):
    pass


# --- Frame format errors (reference: src/lz4f.zig:31-59) ---

class FrameError(LZ4Error):
    """Base class for frame-format errors."""


class Generic(FrameError):
    pass


class MaxBlockSizeInvalid(FrameError):
    pass


class BlockModeInvalid(FrameError):
    pass


class ParameterInvalid(FrameError):
    pass


class CompressionLevelInvalid(FrameError):
    pass


class HeaderVersionWrong(FrameError):
    pass


class BlockChecksumInvalid(FrameError):
    pass


class ReservedFlagSet(FrameError):
    pass


class FrameAllocationFailed(FrameError):
    pass


class SrcSizeTooLarge(FrameError):
    pass


class DstMaxSizeTooSmall(FrameError):
    pass


class FrameHeaderIncomplete(FrameError):
    pass


class FrameTypeUnknown(FrameError):
    pass


class FrameSizeWrong(FrameError):
    pass


class SrcPtrWrong(FrameError):
    pass


class FrameDecompressionFailed(FrameError):
    pass


class HeaderChecksumInvalid(FrameError):
    pass


class ContentChecksumInvalid(FrameError):
    pass


class FrameDecodingAlreadyStarted(FrameError):
    pass


class CompressionStateUninitialized(FrameError):
    pass


class ParameterNull(FrameError):
    pass


class MaxCode(FrameError):
    pass


class OutOfMemory(FrameError):
    pass


#: Numeric error codes, for the native (C++) boundary and for parity
#: with the reference's ``isError`` numeric convention
#: (reference: src/lz4f.zig:57-59).
BLOCK_ERROR_CODES = {
    1: OutputTooSmall,
    2: InputTooLarge,
    3: CorruptedData,
    4: DecompressionFailed,
    5: InvalidState,
    6: AllocationFailed,
}


def raise_block_error(code: int, context: str = "") -> None:
    """Raise the exception mapped to a native/JAX backend error code."""
    if code == 0:
        return
    exc = BLOCK_ERROR_CODES.get(int(code), DecompressionFailed)
    raise exc(context or exc.__name__)
