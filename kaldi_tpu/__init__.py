"""kaldi_tpu — a speech recognition framework in JAX.

A from-scratch re-design of the Kaldi ASR toolkit (reference:
chenzhehuai/kaldi) for accelerators: feature extraction, GMM and
neural acoustic models, WFST graph compilation, token-passing Viterbi
beam-search decoding with lattice generation — expressed as JAX/XLA
programs over device meshes rather than C++/CUDA kernels.  Its
accelerator is an NVIDIA GPU (H100).

Layer map (mirrors reference SURVEY.md §1, collapsed):

  core/      logging, options, extended-filename I/O, ark/scp tables  (L0, L2)
  features/  framing, STFT, mel, MFCC/fbank/PLP, CMVN, deltas, splice (L4)
  fst/       WFST types + algorithms, L/G/C/H construction, HCLG, CSR (L6)
  am/        GMM, decision tree, HMM topology/transitions, TDNN, chain(L5)
  decoder/   vectorized token-passing beam search + lattice generation(L7)
  lattice/   lattice determinization, best-path, MBR, rescoring       (L8)
  parallel/  mesh / sharding / collective helpers                     (comm)
  pipelines/ training + decoding recipes (stage-cached)               (L10/11)
  cli/       command-line entry points mirroring kaldi binary names   (L10)
"""

__version__ = "0.1.0"
