"""Leveled RNS-CKKS on PyTorch int64 residue tensors.

Layers (bottom-up), each the counterpart of the module of the same name
in ``hectr_tpu.ckks``:
  primes    -- prime-chain / root-of-unity generation (host, exact ints)
  modmath   -- Barrett/Shoup modular arithmetic on int64 tensors
  ntt       -- negacyclic NTT/iNTT (CUDA kernels on the card, plain
               PyTorch on the CPU)
  encoding  -- canonical-embedding encode/decode (matrix branch)
  dd        -- double-double arithmetic for decode
  context   -- parameter presets -> prime chain and cached device tables
  basecvt   -- RNS base conversion
  scheme    -- keygen, encrypt/decrypt, add/sub/neg, ct-pt mult, rescale
  keyswitch -- hybrid key switching, Galois rotations, ct x ct multiply
  gemv      -- plaintext-matrix x ciphertext-vector products
"""
