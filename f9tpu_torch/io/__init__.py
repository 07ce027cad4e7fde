"""Host codecs: the port's copy of `f9tpu/io/` (every format the drop zone
takes), with the native twins from `f9tpu_torch.native`."""

from .wav import (  # noqa: F401
    AudioFileInfo, WavReader, WavWriter, probe_wav, read_raw_pcm, read_wav,
    write_wav, write_wav_codes, write_wav_payload,
)
from .aiff import probe_aiff, read_aiff, write_aiff  # noqa: F401
from .flac import (  # noqa: F401
    FlacReader, FlacWriter, probe_flac, read_flac, read_flac_codes,
    write_flac, write_flac_codes,
)
from .codec import SUPPORTED_EXTENSIONS, probe, read_audio, is_supported  # noqa: F401
